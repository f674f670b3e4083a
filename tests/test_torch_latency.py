"""The port's single-solve latency path on the CPU (float64 unless stated):
the single-pose API and the reference-compatible forward-difference dynamics
Jacobians against the JAX package, the FD-Jacobian piano against the
reference golden (tests/test_altro.py:114-124), and the component functions
of ``tools/probe_latency`` at a tiny size (untimed: times come from the
card)."""

import collections
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcol_tpu.systems import cone_through_wall as jcone
from dcol_tpu.systems import piano_mover as jpiano
from dcol_tpu.systems import quadrotor as jquad
from dcol_tpu_torch.parallel.batch import solve_single
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.systems import cone_through_wall, piano_mover, quadrotor
from dcol_tpu_torch.tools import probe_latency

torch.set_num_threads(1)

F64 = torch.float64
# f64: same PDIP iterations on both sides, iterates equal to rounding;
# forward differences magnify 1-ulp differences by 1/delta = 1e6
ATOL = 1e-8
GOLD = os.path.join(os.path.dirname(__file__), "goldens")
SYSTEMS = {"piano_mover": (piano_mover, jpiano),
           "coneThroughWall": (cone_through_wall, jcone),
           "quadrotor": (quadrotor, jquad)}


def T(a):
    return torch.tensor(np.asarray(a), dtype=F64)


@pytest.mark.parametrize("name", ["piano_mover", "quadrotor"])
def test_single_pose_api_matches_jax(name):
    """``CollisionScene.alphas`` / ``alphas_and_grads`` and
    ``System.constraints_x`` / ``constraints_x_vg`` for one state (no
    scenario or knot dim) against the JAX package's, atol 1e-8."""
    if name == "piano_mover":
        jsys, jparams, _, _, _ = jpiano.make_problem(dtype=jnp.float64,
                                                     backend="xla")
        sys_, params, _, _, _ = piano_mover.make_problem(F64, "cpu")
    else:
        jsys, jparams, _, _, _ = jquad.make_problem(dtype=jnp.float64, N=10,
                                                    backend="xla")
        sys_, params, _, _, _ = quadrotor.make_problem(F64, "cpu", N=10)
    x = np.asarray(jparams["Xref"])[3] + 0.05 * np.random.default_rng(
        4).normal(size=sys_.nx)
    xt = T(x)
    r, p = sys_.robot_pose(xt)
    obs = (params["obs_r"], params["obs_p"])
    jr, jp = jsys.robot_pose(jnp.asarray(x))
    jobs = (jparams["obs_r"], jparams["obs_p"])

    a = sys_.scene.alphas(r, p, *obs)
    aj = jax.jit(jsys.scene.alphas)(jr, jp, *jobs)
    assert a.shape == (sys_.ncx,)
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), rtol=0, atol=ATOL)
    got = sys_.scene.alphas_and_grads(r, p, *obs)
    want = jax.jit(jsys.scene.alphas_and_grads)(jr, jp, *jobs)
    assert [tuple(g.shape) for g in got] == [(sys_.ncx,), (sys_.ncx, 3),
                                             (sys_.ncx, 3)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)

    h = sys_.constraints_x(params, xt)
    hj = jax.jit(lambda x_: jsys.constraints_x(jparams, x_))(x)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=0, atol=ATOL)
    h2, J = sys_.constraints_x_vg(params, xt)
    hj2, Jj = jax.jit(lambda x_: jsys.constraints_x_vg(jparams, x_))(x)
    assert J.shape == (sys_.ncx, sys_.nx)
    np.testing.assert_allclose(h2.numpy(), np.asarray(hj2), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), rtol=0, atol=ATOL)


def test_single_pose_api_is_the_trajectory_api_at_one_knot():
    """On the grouped quadrotor (7 groups, obstacle order restored) the
    single-pose functions equal the trajectory functions at S = T = 1."""
    sys_, params, _, _, _ = quadrotor.make_problem(F64, "cpu", N=10)
    x = params["Xref"][4] + 0.05 * T(np.random.default_rng(5).normal(
        size=sys_.nx))
    pb = {k: v[None] for k, v in params.items()}
    h, _ = sys_.constraints_x_traj(pb, x[None, None])
    h1 = sys_.constraints_x(params, x)
    assert h1.shape == (sys_.ncx,)
    torch.testing.assert_close(h1, h[0, 0], rtol=0, atol=0)
    hv, J, _ = sys_.constraints_x_vg_traj(pb, x[None, None])
    hv1, J1 = sys_.constraints_x_vg(params, x)
    torch.testing.assert_close(hv1, hv[0, 0], rtol=0, atol=0)
    torch.testing.assert_close(J1, J[0, 0], rtol=0, atol=0)


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_fd_jacobians_match_jax(name):
    """``altro.dynamics_jacobians`` of a system built with
    ``fd_jacobians=True`` against the JAX package's ``dynamics_jacobians``
    in FD mode at random states and controls (atol 1e-8), and within the
    FD truncation error of the exact Jacobians."""
    mod, jmod = SYSTEMS[name]
    jsys = jmod.make_system(N=10, fd_jacobians=True)
    sys_ = mod.make_system(N=10, fd_jacobians=True)
    _, params, X0, U0, _ = mod.make_problem(F64, "cpu", N=10)
    _, jparams, _, _, _ = jmod.make_problem(dtype=jnp.float64, N=10,
                                            backend="xla")
    rng = np.random.default_rng(6)
    X = X0[:-1].numpy() + 0.1 * rng.normal(size=(9, sys_.nx))
    U = U0.numpy() + 0.1 * rng.normal(size=(9, sys_.nu))
    pb = {k: v[None] for k, v in params.items()}
    A, B = altro.dynamics_jacobians(sys_, pb, T(X)[None], T(U)[None])
    assert A.shape == (1, 9, sys_.nx, sys_.nx)
    assert B.shape == (1, 9, sys_.nx, sys_.nu)
    jac = jax.jit(jax.vmap(
        lambda x, u, k: jsys.dynamics_jacobians(jparams, x, u, k)))
    Aj, Bj = jac(jnp.asarray(X), jnp.asarray(U), jnp.arange(9))
    np.testing.assert_allclose(A[0].numpy(), np.asarray(Aj), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(B[0].numpy(), np.asarray(Bj), rtol=0,
                               atol=ATOL)
    Ae, Be = altro.dynamics_jacobians(mod.make_system(N=10), pb, T(X)[None],
                                      T(U)[None])
    torch.testing.assert_close(A, Ae, rtol=0, atol=1e-4)
    torch.testing.assert_close(B, Be, rtol=0, atol=1e-4)


def test_fd_jacobians_reproduce_reference_path():
    """``make_system(fd_jacobians=True)`` hits the reference golden's
    iterate path on the piano: the same iteration count, X within 1e-3
    (tests/test_altro.py:114-124)."""
    sys_ = piano_mover.make_system(fd_jacobians=True)
    _, params, X0, U0, cfg = piano_mover.make_problem(F64, "cpu")
    st = solve_single(sys_, params, cfg, X0, U0)
    gold = np.load(os.path.join(GOLD, "ref_piano_mover.npz"))
    assert bool(st.converged) and not bool(st.failed)
    assert int(st.iter) == int(gold["iters"])
    np.testing.assert_allclose(st.X.numpy(), gold["X"], atol=1e-3)


def test_make_problem_defaults_to_the_card_in_f64():
    """Every system's ``make_problem`` defaults to float64 on the card, as
    the JAX package's default dtype; without a card it raises, and nothing
    moves to the CPU."""
    for mod, _ in SYSTEMS.values():
        if torch.cuda.is_available():
            sys_, params, X0, U0, _ = mod.make_problem(N=10)
            assert X0.dtype == F64 and X0.is_cuda
        else:
            with pytest.raises(RuntimeError, match="not available"):
                mod.make_problem(N=10)


def test_probe_latency_components_on_cpu():
    """``probe_latency``'s problem, scenario and solve on the f32 quadrotor
    at N=10 on the CPU, capped at 3 AL iterations: 7 obstacle groups, a
    finite trajectory, and the solve that ``solve_single`` gives."""
    prob = probe_latency.problem("cpu", N=10)
    assert len(prob[0].scene.groups) == 7
    prob = prob[:4] + (dataclasses.replace(prob[4], max_iters=3),)
    scen = probe_latency.scenario(prob, probe_latency.WARM_SEED)
    assert scen[1].shape == prob[2].shape
    assert scen[1].dtype == torch.float32
    st = probe_latency.solve_one(prob, scen)
    assert int(st.iter) == 3 and st.X.shape == (10, 12)
    assert bool(torch.isfinite(st.X).all())
    ref = solve_single(prob[0], scen[0], prob[4], scen[1], scen[2])
    torch.testing.assert_close(st.X, ref.X, rtol=0, atol=0)


def test_probe_latency_counts_constraint_batches():
    """``batches`` reads the wrapper's tally as whole constraint batches:
    every layout of the scene launched equally often."""
    grouped = quadrotor.make_system(N=10).scene
    tally = collections.Counter()
    for lay, idx in grouped.groups:
        tally[(10 * len(idx), lay.nv, lay.n_ort, lay.s1, lay.s2, "cold")] += 4
    assert probe_latency.batches(tally, grouped) == {
        "launches": 28, "batches": 4, "launches_per_batch": 7}
    tally[next(iter(tally))] += 1
    with pytest.raises(ValueError, match="whole constraint batches"):
        probe_latency.batches(tally, grouped)
    lay, idx = grouped.groups[0]
    with pytest.raises(ValueError, match="whole constraint batches"):
        probe_latency.batches(collections.Counter(
            {(10 * len(idx), lay.nv, lay.n_ort, lay.s1, lay.s2, "cold"): 1}),
            grouped)


def test_probe_latency_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="not available"):
        probe_latency.main()
