"""Port MPC and dual-seeded ALTRO solves vs the JAX package (float64 on the
CPU, piano mover): per-tick iterations and closed-loop states of
``mpc_run`` with noise and a sliding reference window, a resumed run
started from the same carry in both packages, and ``solve`` with and
without seeded duals."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcol_tpu.solver import altro as jaltro
from dcol_tpu.solver import mpc as jmpc
from dcol_tpu.systems import piano_mover as jpiano
from dcol_tpu_torch.convert import carry_from_numpy
from dcol_tpu_torch.solver import altro, mpc
from dcol_tpu_torch.systems import piano_mover

torch.set_num_threads(1)

F64 = torch.float64
TICKS, MORE = 3, 2


def _inputs(sys_, X0, Xg):
    """Seeded plant noise for TICKS + MORE ticks and a straight reference
    path from the start to the goal, long enough for every tick's window."""
    rng = np.random.default_rng(3)
    noise = rng.normal(0.0, 1e-3, (TICKS + MORE, sys_.nx))
    a = np.linspace(0.0, 1.0, TICKS + MORE + sys_.N)[:, None]
    path = (1 - a) * X0 + a * Xg
    return noise, path


@pytest.fixture(scope="module")
def problem():
    jsys, jparams, jX0, jU0, jcfg = jpiano.make_problem()
    sys_, params, X0, U0, cfg = piano_mover.make_problem(F64, "cpu")
    jcfg = dataclasses.replace(jcfg, max_iters=40)
    cfg = dataclasses.replace(cfg, max_iters=40)
    noise, path = _inputs(sys_, np.asarray(jX0[0]),
                          np.asarray(jparams["Xref"][-1]))
    jres = jmpc.mpc_run(jsys, jparams, jcfg, jX0[0], jU0, n_steps=TICKS,
                        noise=noise[:TICKS], xref_path=path)
    jmore = jmpc.mpc_run(jsys, jparams, jcfg, jX0[0], jU0, n_steps=MORE,
                         noise=noise[TICKS:], xref_path=path,
                         resume_from=jres.final, k0=TICKS)
    pb = {k: v[None] for k, v in params.items()}
    return dict(sys=sys_, pb=pb, X0=X0, U0=U0, cfg=cfg, noise=noise,
                path=path, jres=jres, jmore=jmore)


def _assert_matches(res, jres):
    """Per-tick iterations and convergence equal; closed-loop states to
    1e-6 and controls to 1e-5 (f64, same iterations: rounding only, grown
    through the closed loop); plan quality to 1e-6."""
    np.testing.assert_array_equal(res.iters[0].numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(res.converged[0].numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_allclose(res.X_applied[0].numpy(),
                               np.asarray(jres.X_applied), rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.U_applied[0].numpy(),
                               np.asarray(jres.U_applied), rtol=0, atol=1e-5)
    for f in ("cost", "convio", "h_applied", "kmax"):
        np.testing.assert_allclose(getattr(res, f)[0].numpy(),
                                   np.asarray(getattr(jres, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_mpc_matches_jax(problem):
    """TICKS ticks with dual warm starts, plant noise and the sliding
    reference window: the same per-tick iterations and closed loop as
    JAX's mpc_run."""
    p = problem
    res = mpc.mpc_run(p["sys"], p["pb"], p["cfg"], p["X0"][None, 0],
                      p["U0"][None], TICKS,
                      noise=torch.tensor(p["noise"][:TICKS]),
                      xref_path=torch.tensor(p["path"]))
    assert res.X_applied.shape == (1, TICKS + 1, p["sys"].nx)
    assert res.iters.shape == (1, TICKS)
    _assert_matches(res, p["jres"])
    for a, ja in zip(res.final, p["jres"].final):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(ja), rtol=1e-6,
                                   atol=1e-6)


def test_mpc_resume_matches_jax(problem):
    """Both packages resume from the SAME carry (JAX's, converted) at
    k0 = TICKS and run MORE ticks in lock-step."""
    p = problem
    carry = carry_from_numpy(p["jres"].final, device="cpu", dtype=F64)
    assert carry.x.shape == (1, p["sys"].nx) and carry.rho.shape == (1,)
    assert carry.mu.shape == (1, p["sys"].N - 1, p["sys"].ncu)
    res = mpc.mpc_run(p["sys"], p["pb"], p["cfg"], None, p["U0"][None], MORE,
                      noise=torch.tensor(p["noise"][TICKS:]),
                      xref_path=torch.tensor(p["path"]), resume_from=carry,
                      k0=TICKS)
    _assert_matches(res, p["jmore"])


def test_solve_with_zero_duals_is_the_cold_start(problem):
    """duals=None reproduces the cold start bit for bit, and explicit zero
    duals with rho = rho0 are the same start."""
    p = problem
    sys_, pb, cfg = p["sys"], p["pb"], dataclasses.replace(p["cfg"],
                                                          max_iters=3)
    X0, U0 = p["X0"][None], p["U0"][None]
    cold = altro.solve(sys_, pb, cfg, X0, U0)
    none = altro.solve(sys_, pb, cfg, X0, U0, duals=None, rho=None)
    zero = altro.solve(
        sys_, pb, cfg, X0, U0,
        duals=(torch.zeros(1, sys_.N - 1, sys_.ncu, dtype=F64),
               torch.zeros(1, sys_.N, sys_.ncx, dtype=F64),
               torch.zeros(1, sys_.nx, dtype=F64)), rho=cfg.rho0)
    def leaves(t):
        if isinstance(t, torch.Tensor):
            yield t
        else:
            for a in t:
                yield from leaves(a)

    trio = list(zip(leaves(cold), leaves(none), leaves(zero)))
    assert len(trio) == len(list(leaves(cold))) > 20
    for a, b, c in trio:
        assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="duals"):
        altro.solve(sys_, pb, cfg, X0, U0,
                    duals=(torch.zeros(1, 2, 2, dtype=F64),) * 3)


def test_seeded_solve_matches_jax(problem):
    """A solve seeded with positive duals and rho = 10 follows JAX's seeded
    solve for 4 iterations (f64, atol 1e-8)."""
    p = problem
    sys_ = p["sys"]
    rng = np.random.default_rng(0)
    mu = np.abs(rng.normal(size=(sys_.N - 1, sys_.ncu))) * 0.1
    mux = np.abs(rng.normal(size=(sys_.N, sys_.ncx))) * 0.1
    lam = rng.normal(size=sys_.nx) * 0.1
    jsys, jparams, jX0, jU0, jcfg = jpiano.make_problem()
    jst = jaltro.solve(jsys, jparams, dataclasses.replace(jcfg, max_iters=4),
                       jX0, jU0, duals=(jnp.asarray(mu), jnp.asarray(mux),
                                        jnp.asarray(lam)), rho=10.0)
    st = altro.solve(sys_, p["pb"], dataclasses.replace(p["cfg"], max_iters=4),
                     p["X0"][None], p["U0"][None],
                     duals=tuple(torch.tensor(a)[None] for a in (mu, mux, lam)),
                     rho=torch.tensor([10.0], dtype=F64))
    assert int(st.iter[0]) == int(jst.iter) == 4
    for f in ("X", "U", "mu", "mux", "lambd", "rho", "J"):
        np.testing.assert_allclose(getattr(st, f)[0].numpy(),
                                   np.asarray(getattr(jst, f)), rtol=1e-8,
                                   atol=1e-8, err_msg=f)
