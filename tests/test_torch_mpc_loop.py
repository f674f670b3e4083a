"""Port MPC closed loops on the piano mover (float64 on the CPU), mirroring
tests/test_parallel.py:124-193: noiseless ticks follow the offline optimum,
dual warm starts cut iterations, and a sliding reference window tracks its
path.  Also the lock-step scenario batch: a batch of two scenarios equals
each scenario run alone."""

import dataclasses

import numpy as np
import torch

from dcol_tpu_torch.parallel.batch import solve_batch
from dcol_tpu_torch.solver import mpc
from dcol_tpu_torch.systems import piano_mover

torch.set_num_threads(1)

F64 = torch.float64


def _small_problem(max_iters=40):
    sys_, params, X0, U0, cfg = piano_mover.make_problem(F64, "cpu")
    pb = {k: v[None] for k, v in params.items()}
    return (sys_, params, pb, X0, U0,
            dataclasses.replace(cfg, max_iters=max_iters))


def _goal_dist(x, params):
    return float(torch.linalg.vector_norm(x[:2] - params["Xref"][-1, :2]))


def test_mpc_tracks_optimal_plan():
    """Noiseless MPC with converged warm-started ticks follows the offline
    optimum's pace: the state at tick 25 stays within 0.3 of the optimum's
    knot 25, and the loop closes at least 40% of the distance to the goal."""
    sys_, params, pb, X0, U0, cfg = _small_problem()
    st = solve_batch(sys_, pb, dataclasses.replace(cfg, max_iters=3000),
                     X0[None], U0[None])
    res = mpc.mpc_run(sys_, pb, cfg, X0[None, 0], U0[None], 25)
    Xa = res.X_applied[0]
    assert bool(torch.isfinite(Xa).all())
    err = float(torch.linalg.vector_norm(Xa[25, :2] - st.X[0, 25, :2]))
    assert err < 0.3, err
    assert _goal_dist(Xa[-1], params) < 0.6 * _goal_dist(X0[0], params)


def test_mpc_dual_warm_start_cuts_iterations():
    """Carrying the AL duals and penalty across ticks converges ticks in
    fewer iterations than U-only warm starts (after the first tick, which
    has no duals to carry), with a closed loop at least as close to the
    goal (within 25%)."""
    sys_, params, pb, X0, U0, cfg = _small_problem()
    warm = mpc.mpc_run(sys_, pb, cfg, X0[None, 0], U0[None], 12,
                       carry_duals=True)
    cold = mpc.mpc_run(sys_, pb, cfg, X0[None, 0], U0[None], 12,
                       carry_duals=False)
    it_warm = float(warm.iters[0, 1:].double().mean())
    it_cold = float(cold.iters[0, 1:].double().mean())
    assert it_warm < it_cold, (it_warm, it_cold)
    d_warm = _goal_dist(warm.X_applied[0, -1], params)
    d_cold = _goal_dist(cold.X_applied[0, -1], params)
    assert d_warm <= d_cold * 1.25 + 1e-3
    assert bool(torch.isfinite(warm.X_applied).all())
    # without carried duals every tick restarts from zero duals
    assert float(cold.final.rho[0]) == cfg.rho0
    assert float(cold.final.mu.abs().max()) == 0.0


def test_mpc_receding_horizon_tracks_path():
    """xref_path slides the tracked window per tick: the closed loop stays
    within 0.5 on average of the early reference path."""
    sys_, params, pb, X0, U0, cfg = _small_problem(max_iters=6)
    n_steps = 10
    a = np.linspace(0.0, 1.0, n_steps + sys_.N)[:, None]
    path = torch.tensor((1 - a) * X0[0].numpy()
                        + a * params["Xref"][-1].numpy())
    res = mpc.mpc_run(sys_, pb, cfg, X0[None, 0], U0[None], n_steps,
                      xref_path=path)
    Xa = res.X_applied[0]
    assert bool(torch.isfinite(Xa).all())
    err = torch.linalg.vector_norm(Xa[1:, :2] - path[1:n_steps + 1, :2],
                                   dim=1)
    assert float(err.mean()) < 0.5, err


def test_mpc_scenario_batch_matches_single():
    """Two scenarios in lock-step (different start states, per-scenario
    noise) give each scenario's own closed loop: a scenario whose tick
    converges early keeps its state while the other iterates (iterations
    equal, states to 1e-9)."""
    sys_, params, pb, X0, U0, cfg = _small_problem(max_iters=6)
    x0 = torch.stack([X0[0], X0[0] + 0.05])
    noise = torch.tensor(np.random.default_rng(4).normal(0, 1e-3,
                                                         (2, 3, sys_.nx)))
    pb2 = {k: v.expand((2,) + v.shape[1:]).contiguous() for k, v in pb.items()}
    both = mpc.mpc_run(sys_, pb2, cfg, x0, U0[None].repeat(2, 1, 1), 3,
                       noise=noise)
    for s in range(2):
        one = mpc.mpc_run(sys_, pb, cfg, x0[s:s + 1], U0[None], 3,
                          noise=noise[s:s + 1])
        np.testing.assert_array_equal(both.iters[s].numpy(),
                                      one.iters[0].numpy())
        np.testing.assert_allclose(both.X_applied[s].numpy(),
                                   one.X_applied[0].numpy(), rtol=0,
                                   atol=1e-9)
