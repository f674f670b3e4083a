"""The inputs of the paths the benchmark scripts run, built by the port's
judging tool (``dcol_tpu_torch/tools/hard_lanes.py``) as the JAX package's
scripts build them, on the CPU.

- The inputs, one case each, against the JAX package's construction: the
  f32 piano's ``perturb_scenarios(n=64, seed, x0_sigma=0.02)`` at seeds
  0-6 and the cone's nominal batch of 64 (``sigma=0``), as
  ``benchmarks/bench_systems.py`` builds them; the latency path's
  ``probe_latency.scenario`` at seeds 9-14 against ``perturb_scenarios(n=1,
  seed)`` (``bench.py``); the MPC's initial states
  (``hard_lanes.mpc_problem``) against ``benchmarks/bench_mpc.py:93-102``.
- The f32 piano's near-contact batches of 2 perturbed scenarios at their
  initial rollout (no ALTRO solve) through the port's plain ``solve_socp``
  and the JAX package's ``ops/pdip.py::solve_socp``: converged counts
  within ``COUNT_SLACK`` of the batch, alpha within ``ALPHA_ATOL`` (1 +
  |alpha|) where both converge.
- Input handling: ``--scenarios``, ``--sigma``, ``--latency`` and
  ``--mpc``; ``system_problem`` honours the seed at n = 1; the guards of
  the benchmark batches; the MPC judge on synthetic closed-loop states.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcol_tpu.ops.cones import ConeLayout as JLayout
from dcol_tpu.ops.pdip import solve_socp as jax_solve
from dcol_tpu.parallel import batch as jbatch
from dcol_tpu.systems import cone_through_wall as jcone
from dcol_tpu.systems import piano_mover as jpiano
from dcol_tpu.systems import quadrotor as jquad
from dcol_tpu_torch.ops.pdip import solve_socp
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.solver.mpc import MpcResult
from dcol_tpu_torch.tools import hard_lanes, probe_latency, roofline

torch.set_num_threads(1)

F32 = torch.float32
JAX_SYSTEMS = {"piano_mover": jpiano, "coneThroughWall": jcone,
               "quadrotor": jquad}


@functools.lru_cache(maxsize=None)
def _jax_problem(system, N=None):
    kw = {} if N is None else {"N": N}
    return JAX_SYSTEMS[system].make_problem(dtype=jnp.float32, **kw)


@functools.lru_cache(maxsize=None)
def _latency_problem():
    return probe_latency.problem("cpu")


def _equal(jax_arrays, port_arrays):
    """Two (params, X0, U0) triples bit for bit, as numpy."""
    jp, jx, ju = jax_arrays
    pp, px, pu = port_arrays
    np.testing.assert_array_equal(np.asarray(jx), px.numpy())
    np.testing.assert_array_equal(np.asarray(ju), pu.numpy())
    assert sorted(jp) == sorted(pp)
    for k in pp:
        np.testing.assert_array_equal(np.asarray(jp[k]), pp[k].numpy(),
                                      err_msg=k)


def _systems_batch(system, sigma, seed):
    _, params, X0, U0, _ = _jax_problem(system)
    ref = jbatch.perturb_scenarios(params, X0, U0,
                                   n=hard_lanes.SYSTEMS_BATCH, seed=seed,
                                   x0_sigma=sigma)
    _, pb, xb, ub, _ = hard_lanes.system_problem(
        system, F32, "cpu", seed=seed, n=hard_lanes.SYSTEMS_BATCH,
        sigma=sigma)
    _equal(ref, (pb, xb, ub))
    return xb


def _latency(seed):
    _, params, X0, U0, _ = _jax_problem("quadrotor")
    jp, jx, ju = jbatch.perturb_scenarios(params, X0, U0, n=1, seed=seed,
                                          x0_sigma=0.02)
    p, x, u = probe_latency.scenario(_latency_problem(), seed)
    _equal(({k: v[0] for k, v in jp.items()}, jx[0], ju[0]), (p, x, u))


def _mpc(_):
    """bench_mpc.py:93-102 at S = 128, N = 40, 8 iterations a tick."""
    S, N = hard_lanes.MPC_S, hard_lanes.MPC_N
    sys_j, params, X0, U0, _ = _jax_problem("quadrotor", N)
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(np.asarray(X0[0])[None]
                      + rng.normal(0, 0.02, (S, sys_j.nx)), jnp.float32)
    sys_, pb, cfg, px0s, Ub = hard_lanes.mpc_problem("cpu")
    assert sys_.N == N and cfg.max_iters == hard_lanes.MPC_TICK_ITERS == 8
    np.testing.assert_array_equal(np.asarray(x0s), px0s.numpy())
    np.testing.assert_array_equal(
        np.broadcast_to(np.asarray(U0), (S,) + U0.shape), Ub.numpy())
    assert sorted(params) == sorted(pb)
    for k, v in params.items():
        np.testing.assert_array_equal(
            np.broadcast_to(np.asarray(v), (S,) + v.shape), pb[k].numpy(),
            err_msg=k)


CASES = ([(f"piano seed {s}", _systems_batch, ("piano_mover", 0.02, s))
          for s in range(7)]
         + [("cone sigma 0", _systems_batch, ("coneThroughWall", 0.0, 0))]
         + [(f"latency seed {s}", _latency, (s,)) for s in range(9, 15)]
         + [("mpc x0s", _mpc, (None,))])


@pytest.mark.parametrize("build, args", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_inputs_equal_jax(build, args):
    """Each path's inputs equal the JAX scripts' bit for bit."""
    build(*args)


def test_cone_batch_is_the_nominal_problem_replicated():
    """sigma 0 adds exact zeros: every member is the nominal problem, at
    any seed."""
    from dcol_tpu_torch.systems import cone_through_wall

    _, params, X0, U0, _ = cone_through_wall.make_problem(F32, "cpu")
    for seed in (0, 3):
        _, pb, xb, ub, _ = hard_lanes.system_problem(
            "coneThroughWall", F32, "cpu", seed=seed, n=64, sigma=0.0)
        assert torch.equal(xb, X0.expand_as(xb))
        assert torch.equal(ub, U0.expand_as(ub))
        for k, v in params.items():
            assert torch.equal(pb[k], v.expand_as(pb[k])), k


def test_piano_near_contact_parity_with_jax():
    """The f32 piano's near-contact batches of 2 perturbed scenarios at
    their initial rollout: the port's plain solve_socp against the JAX
    package's on the same numpy inputs."""
    sys_, pb, xb, ub, _ = hard_lanes.system_problem(
        "piano_mover", F32, "cpu", seed=1, n=2, sigma=0.02)
    X = altro.initial_rollout(sys_, pb, xb[:, 0], ub)
    batches = hard_lanes.near_contact_batches(sys_, pb, xb, X)
    assert len(batches) == 2
    for b in batches:
        lay = b["lay"]
        assert (lay.s1, lay.s2) == (0, 0)  # iterated in f32 by the kernel
        assert not hard_lanes.iterates_in_f64(F32, lay)
        port = solve_socp(b["c"], b["G"], b["h"], lay, **b["kw"])
        ref = jax_solve(b["c"].numpy(), b["G"].numpy(), b["h"].numpy(),
                        JLayout(lay.n_ort, lay.s1, lay.s2), **b["kw"])
        B = b["c"].shape[0]
        cp, cj = port.converged.numpy(), np.asarray(ref.converged)
        assert abs(int(cp.sum()) - int(cj.sum())) <= (
            hard_lanes.COUNT_SLACK * B), (b["name"], cp.sum(), cj.sum())
        both = cp & cj
        assert both.sum() >= 0.9 * B
        ap = port.x[:, 3].double().numpy()[both]
        aj = np.asarray(ref.x)[:, 3].astype(np.float64)[both]
        assert np.all(np.abs(ap - aj)
                      <= hard_lanes.ALPHA_ATOL * (1 + np.abs(aj))), b["name"]


def test_cli_scenarios_sigma_latency_mpc():
    """--scenarios, --sigma, --latency and --mpc parse, and refuse what
    they cannot mean."""
    a = hard_lanes.parse_args(["--system", "coneThroughWall", "--scenarios",
                               "64", "--sigma", "0", "--seeds", "0"])
    assert (a.system, a.scenarios, a.sigma, a.seeds, a.latency, a.mpc) == (
        "coneThroughWall", 64, 0.0, [0], False, False)
    a = hard_lanes.parse_args(["--system", "quadrotor", "--latency",
                               "--seeds", "9-14"])
    assert a.latency and a.seeds == list(range(9, 15))
    assert a.scenarios is None and a.sigma is None
    assert hard_lanes.parse_args(["--mpc"]).mpc
    d = hard_lanes.parse_args([])
    assert (d.scenarios, d.sigma, d.latency, d.mpc) == (None, None, False,
                                                        False)
    for bad in (["--latency", "--scenarios", "4"], ["--latency", "--sigma",
                                                    "0.1"],
                ["--mpc", "--system", "quadrotor"], ["--mpc", "--latency"],
                ["--scenarios", "0"], ["--sigma", "-1"],
                ["--scenarios", "x"]):
        with pytest.raises(SystemExit):
            hard_lanes.parse_args(bad)
    # RUNS' defaults: the piano's is its nominal problem
    assert hard_lanes.RUNS["piano_mover"] == (1, 0.0, None)
    assert hard_lanes.RUNS["quadrotor"] == (128, 0.02, None)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        hard_lanes.run_seeds("quadrotor", F32, [9], device="cpu",
                             latency=True)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        hard_lanes.run_mpc(device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        roofline.solve_table("piano_mover", 64, device="cpu")


def test_system_problem_honours_seed_at_one_scenario():
    """n = 1 is perturb_scenarios(n=1, seed) as bench.py builds it, not
    the nominal problem; sigma 0 is the nominal problem."""
    from dcol_tpu_torch.systems import piano_mover

    _, _, X0, _, _ = piano_mover.make_problem(F32, "cpu")
    xs = [hard_lanes.system_problem("piano_mover", F32, "cpu", seed=s, n=1)[2]
          for s in (1, 2)]
    assert not torch.equal(xs[0], xs[1])
    assert not torch.equal(xs[0][0], X0)
    assert torch.equal(xs[0][0, 1:], X0[1:])  # only x0 is perturbed
    nominal = hard_lanes.system_problem("piano_mover", F32, "cpu", seed=5,
                                        n=1, sigma=0.0)[2]
    assert torch.equal(nominal[0], X0)
    # the latency path's scenario is this one at the quadrotor's seed
    p, x, u = probe_latency.scenario(_latency_problem(), 11)
    _, pb, xb, ub, _ = hard_lanes.system_problem("quadrotor", F32, "cpu",
                                                 seed=11, n=1)
    assert torch.equal(x, xb[0]) and torch.equal(u, ub[0])


def _stats(**edit):
    good = {"n": 64, "converged": 64, "mean_iters": 36.4, "finite": True,
            "max_h": 1e-5, "goal_err": 1e-4, "iters_equal": True,
            "X_equal": True}
    return dict(good, **edit)


@pytest.mark.parametrize("seed, mean, fails", [
    (2, 36.5, False), (2, 36.99, False), (2, 37.01, True), (3, 36.29, True),
    (0, 34.0, False), (1, 38.9, False), (0, 39.2, True), (1, 33.9, True)])
def test_piano_guards(seed, mean, fails):
    """The piano's batch: within 0.5 of JAX's mean at seeds 2-6, in 34-39
    at seeds 0-1, and the common guards."""
    assert bool(hard_lanes.piano_failures(_stats(mean_iters=mean), seed)) \
        is fails
    assert len(hard_lanes.piano_failures(_stats(converged=63), 2)) == 1
    missed, jax_mean = hard_lanes.guards(
        "piano_mover", F32, 64, 0.02, seed, _stats(mean_iters=mean))
    assert bool(missed) is fails
    assert jax_mean == hard_lanes.PIANO_JAX_MEAN_ITERS.get(seed)


def test_cone_and_other_guards():
    """The cone's replicated batch: members equal bit for bit, no band;
    batches no benchmark runs have no guards."""
    assert hard_lanes.cone_failures(_stats(mean_iters=70.0)) == []
    assert len(hard_lanes.cone_failures(_stats(iters_equal=False))) == 1
    assert len(hard_lanes.cone_failures(_stats(X_equal=False))) == 1
    missed, jax_mean = hard_lanes.guards("coneThroughWall", F32, 64, 0.0, 4,
                                         _stats(X_equal=False))
    assert len(missed) == 1 and jax_mean == 50.0
    main, _ = hard_lanes.guards("quadrotor", F32, 128, 0.02, 1,
                                _stats(n=128, converged=128,
                                       mean_iters=47.6))
    assert main == []
    for key in (("quadrotor", F32, 64, 0.02), ("piano_mover", F32, 1, 0.0),
                ("piano_mover", torch.float64, 64, 0.02),
                ("coneThroughWall", F32, 32, 0.02)):
        assert hard_lanes.guards(*key, 0, _stats()) == (None, None)


def test_solve_stats_members_equal():
    """solve_stats says whether every member's iterations and X equal the
    first's bit for bit."""
    from dcol_tpu_torch.systems import piano_mover

    sys_, params, X0, U0, _ = piano_mover.make_problem(F32, "cpu")
    pb = {k: v[None].repeat((3,) + (1,) * v.dim()) for k, v in
          params.items()}
    X = X0[None].repeat(3, 1, 1)
    fields = dict(X=X, U=U0[None].repeat(3, 1, 1),
                  converged=torch.zeros(3, dtype=torch.bool),
                  failed=torch.zeros(3, dtype=torch.bool),
                  iter=torch.full((3,), 7))
    s = hard_lanes.solve_stats(sys_, pb, type("St", (), fields))
    assert s["iters_equal"] and s["X_equal"]
    fields["X"] = X.clone()
    fields["X"][2, 5, 0] += 1e-7
    fields["iter"] = torch.tensor([7, 7, 8])
    s = hard_lanes.solve_stats(sys_, pb, type("St", (), fields))
    assert not s["iters_equal"] and not s["X_equal"]


def test_judge_mpc_on_cpu():
    """judge_mpc builds one cold batch per obstacle group at the closed-loop
    states (B = S x states x the group's obstacles) and judges them; h from
    the cold alphas is what constraints_x_traj computes at the ticks'
    states."""
    sys_, pb, cfg, x0s, Ub = hard_lanes.mpc_problem("cpu", S=2)
    X = torch.stack([x0s, x0s + 0.05, x0s + 0.1], dim=1)  # 2 ticks
    hx, _ = sys_.constraints_x_traj(pb, X[:, :-1])
    z = torch.zeros(2, 2)
    res = MpcResult(X, torch.zeros(2, 2, sys_.nu), z, z.bool(), z, z,
                    hx.amax(-1), z)
    batches, v = hard_lanes.judge_mpc(sys_, pb, res, solve_socp)
    groups = sys_.scene.groups
    assert [b["name"] for b in batches] == [f"mpc X_applied {idx}"
                                            for _, idx in groups]
    assert [b["c"].shape[0] for b in batches] == [2 * 3 * len(idx)
                                                  for _, idx in groups]
    assert hard_lanes.verdict_failures(v["totals"]) == []
    assert v["totals"]["problems"] == 2 * 3 * sys_.scene.n_obs
    assert v["h_max_abs_diff"] <= 1e-5, v["h_max_abs_diff"]
    assert v["h_applied_max"] == float(hx.amax())


def test_run_shape_defaults():
    """A run over seeds takes RUNS' count with RUNS' sigma (the piano's
    nominal problem), and a count given without a sigma is perturbed at
    0.02 as the benchmark scripts perturb."""
    assert hard_lanes.run_shape("piano_mover") == (1, 0.0, None)
    assert hard_lanes.run_shape("piano_mover", 64) == (64, 0.02, None)
    assert hard_lanes.run_shape("coneThroughWall", 64, 0.0) == (64, 0.0, 80)
    assert hard_lanes.run_shape("quadrotor", sigma=0.05) == (128, 0.05, None)
