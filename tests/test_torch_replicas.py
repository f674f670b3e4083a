"""Identical scenarios in one batch come out equal.

``benchmarks/bench_systems.py`` runs the cone's nominal problem replicated
64 times, and a scenario's result must not depend on where it sits in the
batch.  Three ops rounded a problem by its position, and each now computes
in a form that does not:

- the cost's sums over (knots, components), one dim at a time
  (``solver/altro.py::_sum_knots``); on the card one reduction grouped
  each row by its address;
- the envelope Lagrangian's G x, the JAX package's elementwise contraction
  (``systems/base.py::lagrangian_gx``); on the card a batched matmul parted
  47 of 64 cone replicas;
- the plain PDIP version's SOC fourth root, two square roots
  (``ops/cones.py::_soc_nt``); on the CPU ATen's pow rounds a tensor's
  vectorised body and its scalar tail differently.

The CPU tests run a few replicas (``tools/replicas.py``'s sweep at its
small size: ``tests/test_torch_replica_sweep.py``); the ``cuda`` ones run
64 on the card and skip without one.
"""

import pytest
import torch

from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.systems.base import jvp, lagrangian_gx
from dcol_tpu_torch.tools import hard_lanes, replicas

torch.set_num_threads(1)

F32 = torch.float32


def _device(where):
    if where == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device(where), (4 if where == "cpu" else 64)


def _members_equal(t):
    return bool(((t == t[:1]) | (t.isnan() & t[:1].isnan())).all())


def _replicated_cone(dev, n):
    sys_, pb, xb, ub, cfg = hard_lanes.system_problem(
        "coneThroughWall", F32, dev, seed=0, n=n, sigma=0.0)
    return sys_, pb, cfg, altro.make_initial_state(sys_, pb, cfg, xb, ub)


DEVICES = [pytest.param("cpu", id="cpu"),
           pytest.param("cuda", id="cuda", marks=pytest.mark.cuda)]


@pytest.mark.parametrize("where", DEVICES)
def test_replicated_cost(where):
    """The cone's nominal problem replicated, after one ALTRO iteration
    (its states still equal): the total cost is equal across replicas
    (every other row's differed by 7.6e-6 on the card when the sums ran
    in one reduction)."""
    dev, n = _device(where)
    sys_, pb, cfg, st = _replicated_cone(dev, n)
    st = altro.altro_iteration(sys_, pb, cfg, st)
    for name in ("X", "U", "mu", "mux", "lambd", "hx", "hu"):
        assert _members_equal(getattr(st, name)), name
    J = altro.total_cost(sys_, pb, st.X, st.U, st.hx, st.hu, st.mu, st.mux,
                         st.lambd, st.rho)
    assert _members_equal(J) and _members_equal(st.J)


def test_replicated_iterations_stay_equal_on_cpu():
    """Three ALTRO iterations of the replicated cone on the CPU: every
    field of the state stays equal across replicas."""
    dev, n = _device("cpu")
    sys_, pb, cfg, st = _replicated_cone(dev, n)
    for _ in range(3):
        st = altro.altro_iteration(sys_, pb, cfg, st)
        for name in ("X", "U", "mu", "mux", "lambd", "hx", "J", "delta_J"):
            assert _members_equal(getattr(st, name)), name


@pytest.mark.cuda
def test_envelope_gx_keeps_replicas_equal_on_card():
    """At the replicated cone's first polish on the card, the envelope
    Lagrangian's G x as the port forms it (``lagrangian_gx``, the JAX
    package's contraction) is equal across the 64 replicas, and so are
    the envelope gradients (a batched matmul parted 47 of them)."""
    dev, n = _device("cuda")
    sys_, pb, _, st = _replicated_cone(dev, n)
    scene = sys_.scene
    rs, ps = sys_.robot_pose(st.X)
    sols, _ = scene._solve_groups_traj(
        rs, ps, pb["obs_r"], pb["obs_p"], st.warm,
        margin=scene.opts.polish_margin)
    S, T = rs.shape[:2]
    xs = tuple(s.x.reshape(S, T, -1, s.x.shape[-1]) for s in sols)
    zs = tuple(s.z.reshape(S, T, -1, s.z.shape[-1]) for s in sols)
    assert all(_members_equal(x) for x in xs + zs)
    basis = torch.eye(6, dtype=F32, device=dev)[:, None, None, :]
    shape6 = (6,) + rs.shape
    _, (_, dG, _) = jvp(
        lambda r_, p_: scene.assemble_groups(
            r_, p_, pb["obs_r"][:, None], pb["obs_p"][:, None])[0],
        (rs.expand(shape6).contiguous(), ps.expand(shape6).contiguous()),
        (basis[..., :3].expand(shape6).contiguous(),
         basis[..., 3:].expand(shape6).contiguous()))
    first = lambda t: t.movedim(0, 1)  # replicas first
    assert _members_equal(first(dG))
    assert _members_equal(first(lagrangian_gx(dG, xs[0])))
    d_r, d_p = scene._envelope_grads(rs, ps, pb["obs_r"], pb["obs_p"], xs,
                                     zs)
    assert _members_equal(d_r) and _members_equal(d_p)


@pytest.mark.cuda
def test_replicated_cone_solve_on_card():
    """bench_systems.py's cone batch, the nominal problem x 64 capped at
    80, through the kernel: ``hard_lanes.cone_failures`` finds nothing
    (64/64 converged, every member's iterations equal and X bitwise
    equal, the cold re-check)."""
    from dcol_tpu_torch.parallel.batch import solve_batch

    dev, n = _device("cuda")
    sys_, pb, xb, ub, cfg = hard_lanes.system_problem(
        "coneThroughWall", F32, dev, seed=0, n=n, sigma=hard_lanes.CONE_SIGMA,
        max_iters=hard_lanes.CONE_MAX_ITERS)
    st = solve_batch(sys_, pb, cfg, xb, ub)
    stats = hard_lanes.solve_stats(sys_, pb, st)
    assert hard_lanes.cone_failures(stats) == [], stats["iters"]


def test_sum_knots_is_the_sum():
    """_sum_knots sums each scenario's last two dims."""
    a = torch.randn(3, 7, 5, dtype=torch.float64)
    torch.testing.assert_close(altro._sum_knots(a), a.sum(dim=(-2, -1)),
                               rtol=1e-14, atol=1e-14)


def test_replicas_tool_on_cpu():
    """tools/replicas.py's probes on the CPU, where nothing parts: the
    plain version gives replicated PDIP batches identical outputs, and no
    step of the replicated cone's first iteration parts."""
    dev = torch.device("cpu")
    assert replicas.parted(torch.tensor([[1.0, 2.0], [1.0, 2.5]])) == (
        1, 0.5)
    pdip = replicas.pdip_replicas(dev, 2)
    assert len(pdip) == 6 and all(v["parted"] == 0 for v in pdip.values())
    sys_, pb, cfg, st = _replicated_cone(dev, 2)
    rows = replicas.stages(sys_, pb, cfg, st)
    names = [name.split(":")[0] for name, _, _ in rows]
    for step in ("rollout", "dynamics Jacobians", "polish PDIP",
                 "lagrangian_gx", "envelope gradients", "Riccati",
                 "line search alpha 1..1", "line search alpha 0.5..0.0625",
                 "accepted step", "AL update"):
        assert step in names, step
    assert replicas.first_parted(rows) is None, rows
