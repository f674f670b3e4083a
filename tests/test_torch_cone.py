"""Port cone-through-wall system vs the JAX package and the reference
trajectory (float64 on the CPU): ``mrp_from_quat``, the problem's
parameters and settings, and a full solve held to the "as good as
reference" standard of tests/test_altro.py."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcol_tpu.geometry.mrp import mrp_from_quat as jmrp_from_quat
from dcol_tpu.systems import cone_through_wall as jcone
from dcol_tpu_torch import main as cli
from dcol_tpu_torch.geometry.mrp import mrp_from_quat
from dcol_tpu_torch.parallel.batch import solve_batch
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.systems import cone_through_wall

torch.set_num_threads(1)

F64 = torch.float64
GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def test_mrp_from_quat_matches_jax():
    """Batched port vs JAX per quaternion, f64 (rtol 1e-15: one divide)."""
    q = np.random.default_rng(0).normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, 0] = np.abs(q[:, 0])
    want = np.asarray(jax.vmap(jmrp_from_quat)(q))
    got = mrp_from_quat(torch.tensor(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float64, jnp.float64),
                                          (torch.float32, jnp.float32)])
def test_params_and_settings_match_jax(dtype, jdtype):
    """Parameters equal JAX's exactly in both dtypes; the f32 problem keeps
    pdip_tol 1e-5, jitter 1e-6 and ls_slack 1e-4."""
    jsys, jparams, jX0, jU0, jcfg = jcone.make_problem(dtype=jdtype,
                                                       backend="xla")
    sys_, params, X0, U0, cfg = cone_through_wall.make_problem(dtype, "cpu")
    assert set(params) == set(jparams)
    for k in params:
        assert params[k].dtype == dtype
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jparams[k]), err_msg=k)
    np.testing.assert_array_equal(X0.numpy(), np.asarray(jX0))
    np.testing.assert_array_equal(U0.numpy(), np.asarray(jU0))
    assert (sys_.nx, sys_.nu, sys_.N, sys_.dt) == (jsys.nx, jsys.nu, jsys.N,
                                                  jsys.dt)
    o, jo = sys_.scene.opts, jsys.scene.opts
    assert (o.tol, o.max_iters, o.jitter) == (jo.tol, jo.max_iters,
                                             jo.jitter)
    for f in ("ls_slack", "max_iters", "max_ls_iters", "atol", "convio_tol",
              "rho0", "phi", "reg_min", "reg_max"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    if dtype == torch.float32:
        assert (o.tol, o.jitter, cfg.ls_slack) == (1e-5, 1e-6, 1e-4)
    assert [((g.nv, g.n_ort, g.s1, g.s2), idx)
            for g, idx in sys_.scene.groups] == [((4, 7, 3, 0), (0, 1, 2, 3))]
    assert cone_through_wall.MASS == jcone.MASS
    np.testing.assert_array_equal(cone_through_wall.INERTIA_DIAG,
                                  jcone.INERTIA_DIAG)


def test_horizon_beyond_fixture_raises():
    cone_through_wall.make_problem(F64, "cpu", N=30)
    with pytest.raises(ValueError, match="exceeds the pinned seed-2 U0"):
        cone_through_wall.make_problem(F64, "cpu", N=61)


def test_cli_accepts_cone(monkeypatch):
    """``--system coneThroughWall`` (the JAX CLI's name) builds the cone
    problem; the solve itself (``solve_batch`` under ``--no-viz``; the
    renders need ``solve_verbose``'s history) is replaced by a stub here."""
    from dcol_tpu_torch.parallel import batch

    class Stop(Exception):
        pass

    seen = {}

    def stub(sys_, params_b, cfg, X0_b, U0_b):
        seen["sys"] = sys_
        raise Stop

    monkeypatch.setattr(batch, "solve_batch", stub)
    with pytest.raises(Stop):
        cli.main(["--system", "coneThroughWall", "--device", "cpu",
                  "--no-viz"])
    assert isinstance(seen["sys"], cone_through_wall.ConeThroughWall)


def test_cone_solve_as_good_as_reference():
    """f64 solve on the CPU: converged, goal met to 1e-4, no collision
    (max h < 1e-3), tracking cost <= 1.001 x the reference's and
    violation no worse than the reference's or the solver's spec
    (tests/test_altro.py:37-65)."""
    sys_, params, X0, U0, cfg = cone_through_wall.make_problem(F64, "cpu")
    pb = {k: v[None] for k, v in params.items()}
    st = solve_batch(sys_, pb, cfg, X0[None], U0[None])
    assert bool(st.converged[0]) and not bool(st.failed[0])
    np.testing.assert_allclose(st.X[0, -1].numpy(),
                               params["Xref"][-1].numpy(), atol=1e-4)
    assert float(st.hx.max()) < 1e-3
    gold = np.load(os.path.join(GOLD, "ref_coneThroughWall.npz"))
    Xg, Ug = torch.tensor(gold["X"])[None], torch.tensor(gold["U"])[None]
    J = float(altro.quad_cost(sys_, pb, st.X, st.U)[0])
    J_ref = float(altro.quad_cost(sys_, pb, Xg, Ug)[0])
    assert J <= J_ref * 1.001, (J, J_ref)
    hx_ref, _, _ = altro.eval_constraints(sys_, pb, Xg, Ug)
    assert float(st.hx.max()) <= max(float(hx_ref.max()), 1e-4 / 2)
