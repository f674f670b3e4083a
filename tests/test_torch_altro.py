"""Port ALTRO solver vs the reference goldens and vs the JAX package
(float64 on the CPU): the piano mover's golden solve, chunked vs sequential
line search, the first AL iterations of a 2-scenario quadrotor batch against
JAX's vmap of the same functions, the scenario batching and the CLI."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcol_tpu.parallel import batch as jbatch
from dcol_tpu.solver import altro as jaltro
from dcol_tpu.systems import quadrotor as jquad
from dcol_tpu_torch import main as cli
from dcol_tpu_torch.convert import params_from_numpy
from dcol_tpu_torch.parallel.batch import (perturb_scenarios, solve_batch,
                                           solve_single, summarize)
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.systems import piano_mover, quadrotor
from dcol_tpu_torch.utils.metrics import iteration_table

torch.set_num_threads(1)

F64 = torch.float64
GOLD = os.path.join(os.path.dirname(__file__), "goldens")


@pytest.fixture(scope="module")
def piano():
    """One f64 piano solve as a batch of one scenario."""
    sys_, params, X0, U0, cfg = piano_mover.make_problem(F64, "cpu")
    stb = solve_batch(sys_, {k: v[None] for k, v in params.items()}, cfg,
                      X0[None], U0[None])
    st = altro.AltroState(*[
        a[0] if isinstance(a, torch.Tensor) else
        type(a)(*[b[0] for b in a]) if hasattr(a, "_fields") else
        tuple(tuple(b[0] for b in g) for g in a) for a in stb])
    return sys_, params, X0, U0, cfg, st, stb


def test_piano_mover_matches_reference(piano):
    """35 iterations exactly, X within 1e-3 and U within 1e-2 of the
    reference trajectory, goal within 1e-4 (tests/test_altro.py:23-34)."""
    _, params, _, _, _, st, _ = piano
    gold = np.load(os.path.join(GOLD, "ref_piano_mover.npz"))
    assert bool(st.converged) and not bool(st.failed)
    assert int(st.iter) == int(gold["iters"]) == 35
    np.testing.assert_allclose(st.X.numpy(), gold["X"], atol=1e-3)
    np.testing.assert_allclose(st.U.numpy(), gold["U"], atol=1e-2)
    np.testing.assert_allclose(st.X[-1].numpy(), params["Xref"][-1].numpy(),
                               atol=1e-4)


def test_ls_parallel_matches_sequential(piano):
    """Chunked line search (ls_parallel 4, the default) accepts the same
    alpha sequence and trajectory as sequential backtracking (1) and as
    chunks of 2 (tests/test_altro.py:92)."""
    sys_, params, X0, U0, cfg, st, _ = piano
    n = int(st.iter)
    alphas = st.metrics.alpha[:n].numpy()
    assert (alphas < 1.0).any()  # the solve does backtrack
    pb = {k: v[None] for k, v in params.items()}
    for C in (1, 2):
        stC = solve_batch(sys_, pb, dataclasses.replace(cfg, ls_parallel=C),
                          X0[None], U0[None])
        assert bool(stC.converged[0]) and not bool(stC.failed[0])
        assert int(stC.iter[0]) == n
        np.testing.assert_array_equal(stC.metrics.alpha[0, :n].numpy(), alphas)
        np.testing.assert_allclose(stC.X[0].numpy(), st.X.numpy(), atol=1e-8)


def test_summary_and_iteration_table(piano):
    sys_, params, X0, U0, cfg, st, stb = piano
    s = summarize(stb)
    assert s["n"] == 1 and s["n_converged"] == 1 and s["n_failed"] == 0
    assert s["mean_iters"] == 35.0 and s["max_convio"] < 1e-4
    table = iteration_table(stb).splitlines()
    assert len(table) == 2 + 35
    assert table[-1].startswith(" 35 ")
    # solve_single is the same solve without the scenario dim
    one = solve_single(sys_, params, cfg, X0, U0)
    assert int(one.iter) == 35
    np.testing.assert_array_equal(one.X.numpy(), st.X.numpy())


def test_perturb_scenarios_matches_jax():
    """The same seed gives bit-identical scenarios in both packages."""
    jsys, jparams, jX0, jU0, _ = jquad.make_problem(dtype=jnp.float32,
                                                    backend="xla")
    sys_, params, X0, U0, _ = quadrotor.make_problem(torch.float32, "cpu")
    jp, jx, ju = jbatch.perturb_scenarios(jparams, jX0, jU0, n=3, seed=4,
                                          x0_sigma=0.02, obs_sigma=0.01)
    p, x, u = perturb_scenarios(params, X0, U0, n=3, seed=4, x0_sigma=0.02,
                                obs_sigma=0.01)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    for k in jp:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))


@pytest.fixture(scope="module")
def quad_jax():
    """The 2-scenario f64 quadrotor batch (perturb_scenarios seed 0) in
    both packages, with JAX's jitted vmaps of make_initial_state and
    altro_iteration (compiled once for the module)."""
    jsys, jparams, jX0, jU0, jcfg = jquad.make_problem(dtype=jnp.float64,
                                                       backend="xla")
    jp, jx, ju = jbatch.perturb_scenarios(jparams, jX0, jU0, n=2, seed=0)
    init = jax.jit(jax.vmap(
        lambda p, x, u: jaltro.make_initial_state(jsys, p, jcfg, x, u)))
    step = jax.jit(jax.vmap(
        lambda p, s: jaltro.altro_iteration(jsys, p, jcfg, s)))

    sys_, _, _, _, cfg = quadrotor.make_problem(F64, "cpu")
    pb = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu", dtype=F64)
    X0 = torch.tensor(np.asarray(jx))
    U0 = torch.tensor(np.asarray(ju))
    return (jp, jx, ju, init, step), (sys_, pb, cfg, X0, U0)


def _assert_iteration_matches(st, jst):
    for name in ("X", "U", "mux", "rho", "reg", "alpha"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   rtol=0, atol=1e-8, err_msg=name)
    np.testing.assert_array_equal(st.iter.numpy(), np.asarray(jst.iter))


def test_quadrotor_batch_iterations_match_jax(quad_jax):
    """make_initial_state plus 3 altro_iteration steps of a 2-scenario f64
    quadrotor batch (perturb_scenarios seed 0) agree with JAX's vmap of the
    same functions after every step: X, U, mux, rho, reg and alpha to
    atol 1e-8."""
    (jp, jx, ju, init, step), (sys_, pb, cfg, X0, U0) = quad_jax
    jst = init(jp, jx, ju)
    st = altro.make_initial_state(sys_, pb, cfg, X0, U0)
    np.testing.assert_allclose(st.X.numpy(), np.asarray(jst.X), atol=1e-8)
    np.testing.assert_allclose(st.hx.numpy(), np.asarray(jst.hx), atol=1e-8)
    for _ in range(3):
        jst = step(jp, jst)
        st = altro.altro_iteration(sys_, pb, cfg, st)
        _assert_iteration_matches(st, jst)


def test_checkpoint_across_packages(tmp_path, quad_jax):
    """The JAX package's checkpoint.save of that batch's state after 3
    iterations loads in the port's checkpoint.load; one more iteration in
    each package then agrees to atol 1e-8.  (Here and not in
    test_torch_parallel.py: it reuses the compiled JAX iteration, which
    takes minutes to compile on the CPU.)"""
    from dcol_tpu.parallel import checkpoint as jcheckpoint
    from dcol_tpu_torch.parallel import checkpoint

    (jp, jx, ju, init, step), (sys_, pb, cfg, _, _) = quad_jax
    jst = init(jp, jx, ju)
    for _ in range(3):
        jst = step(jp, jst)
    path = str(tmp_path / "jax_state.npz")
    jcheckpoint.save(path, jst)
    st = checkpoint.load(path, device="cpu")
    assert len(st.warm) == 7 and int(st.iter[0]) == 3
    _assert_iteration_matches(altro.altro_iteration(sys_, pb, cfg, st),
                              step(jp, jst))


def test_cli_batch(capsys):
    cli.main(["--system", "piano_mover", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "batch of 2 solved" in out and "'n_converged': 2" in out


def test_cuda_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="not available"):
        quadrotor.make_problem(torch.float32, "cuda")
