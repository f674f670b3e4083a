"""Identical scenarios in one batch, and where the card rounds them apart.

``benchmarks/bench_systems.py`` runs the cone's nominal problem replicated
64 times.  On the card the replicas part after the first iteration, though
every PDIP launch gives them identical solutions: two host-side ops round
a problem by its position in the batch.

- The cost's sums over (knots, components) in one reduction, which the
  card groups by each row's address: repaired, the sums now go one dim at
  a time (``solver/altro.py::_sum_knots``).
- The envelope gradients' ``G @ x`` as a batched matmul
  (``systems/base.py::lagrangian_gx``): open (ROADMAP Queue C).  The elementwise contraction, the JAX package's form, keeps
  the replicas equal, but it also moves the f32 CLI piano on the card from
  35 ALTRO iterations, which ``chip_smoke.py`` phase 13 pins, to 36.

The CPU tests run a few replicas; the ``cuda`` ones run 64 on the card and
skip without one.
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
def test_envelope_matmul_parts_replicas_on_card():
    """The open fault, shown: at the replicated cone's first polish the
    envelope Lagrangian's G x, as the port forms it (a batched matmul),
    differs across the 64 replicas on the card, while the elementwise
    contraction of the same tangents does not.  The repair turns this
    test into one that the port's gradients are equal."""
    dev, n = _device("cuda")
    sys_, pb, _, st = _replicated_cone(dev, n)
    scene = sys_.scene
    rs, ps = sys_.robot_pose(st.X)
    sols, _ = scene._solve_groups_traj(
        rs, ps, pb["obs_r"], pb["obs_p"], st.warm,
        margin=scene.opts.polish_margin)
    S, T = rs.shape[:2]
    x = sols[0].x.reshape(S, T, -1, sols[0].x.shape[-1])
    assert _members_equal(x)
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
    assert _members_equal(first(torch.sum(dG * x[..., None, :], dim=-1)))
    assert not _members_equal(first(lagrangian_gx(dG, x)))


def test_sum_knots_is_the_sum():
    """_sum_knots sums each scenario's last two dims."""
    a = torch.randn(3, 7, 5, dtype=torch.float64)
    torch.testing.assert_close(altro._sum_knots(a), a.sum(dim=(-2, -1)),
                               rtol=1e-14, atol=1e-14)


def test_replicas_tool_on_cpu():
    """tools/replicas.py's probes on the CPU, where nothing parts: the
    plain version gives replicated PDIP batches identical outputs, and the
    first polish and the cost after one iteration are equal under every
    form."""
    dev = torch.device("cpu")
    assert replicas.parted(torch.tensor([[1.0, 2.0], [1.0, 2.5]])) == (
        1, 0.5)
    pdip = replicas.pdip_replicas(dev, 2)
    assert len(pdip) == 6 and all(v["parted"] == 0 for v in pdip.values())
    for probe in (replicas.first_polish(dev, 2),
                  replicas.cost_after_one(dev, 2)):
        assert all(v[0] == 0 for v in probe.values()), probe

