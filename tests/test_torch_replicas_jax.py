"""The forms that keep replicated scenarios equal, against the JAX package
(on the CPU).

- ``systems/base.py::lagrangian_gx``, the envelope Lagrangian's G x, is
  the JAX package's contraction ``jnp.sum(G * x[..., None, :], -1)``
  (``dcol_tpu/systems/base.py``, ``lag_vec``) on seeded inputs.
- The cone's envelope gradients (constraint values and dh/dx rows of the
  polish path, ``constraints_x_vg_traj``) against the JAX package's; the
  quadrotor's are held to it by
  ``tests/test_torch_scene.py::test_constraints_match_jax``.
- The plain version's SOC fourth root (``ops/cones.py::_soc_nt``, two
  square roots) against the JAX package's ``(js / jz) ** 0.25``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcol_tpu.ops import cones as jcones
from dcol_tpu.systems import cone_through_wall as jcone
from dcol_tpu_torch.ops import cones
from dcol_tpu_torch.systems import cone_through_wall
from dcol_tpu_torch.systems.base import lagrangian_gx

torch.set_num_threads(1)

TOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_lagrangian_gx_is_the_jax_form(dtype):
    """G (6, S, T, n_g, nr, nv) of the envelope's tangents and x (S, T,
    n_g, nv), as ``_envelope_grads`` passes them: within 1e-6 in f32 and
    1e-12 in f64 of the JAX package's contraction."""
    rng = np.random.default_rng(12)
    G = rng.uniform(-1, 1, (6, 3, 7, 2, 13, 5)).astype(dtype)
    x = rng.uniform(-1, 1, (3, 7, 2, 5)).astype(dtype)
    want = np.asarray(jax.jit(lambda G_, x_: jnp.sum(
        G_ * x_[..., None, :], axis=-1))(G, x))
    got = lagrangian_gx(torch.from_numpy(G), torch.from_numpy(x)).numpy()
    assert got.dtype == dtype and got.shape == (6, 3, 7, 2, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


def test_cone_envelope_grads_match_jax():
    """The cone's constraint values and their dh/dx rows (the envelope
    gradients through the pose Jacobian) at a perturbed reference
    trajectory, cold, in f64: within 1e-8 of the JAX package's."""
    jsys, jparams, _, _, _ = jcone.make_problem(dtype=jnp.float64, N=12,
                                                backend="xla")
    sys_, params, _, _, _ = cone_through_wall.make_problem(torch.float64,
                                                           "cpu", N=12)
    X = np.asarray(jparams["Xref"]) + 0.05 * np.random.default_rng(
        3).normal(size=np.asarray(jparams["Xref"]).shape)
    hj, rj, _ = jax.jit(lambda X_: jsys.constraints_x_vg_traj(
        jparams, X_))(X)
    pb = {k: v[None] for k, v in params.items()}
    h, r, _ = sys_.constraints_x_vg_traj(pb, torch.tensor(X)[None])
    assert r.shape == (1, 12, sys_.ncx, sys_.nx)
    assert float(np.abs(np.asarray(rj)).max()) > 0.1  # gradients reach X
    np.testing.assert_allclose(h[0].numpy(), np.asarray(hj), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(r[0].numpy(), np.asarray(rj), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_soc_fourth_root_matches_jax(dtype):
    """The NT scaling of an SOC block, (eta, wbar), against the JAX
    package's on seeded interior points: eta within 2 ulps."""
    rng = np.random.default_rng(5)
    v = rng.normal(size=(257, 4)).astype(dtype)
    s = np.concatenate([np.linalg.norm(v[:, 1:], axis=1, keepdims=True)
                        * 1.5 + 0.1, v[:, 1:]], axis=1).astype(dtype)
    w = rng.normal(size=(257, 4)).astype(dtype)
    z = np.concatenate([np.linalg.norm(w[:, 1:], axis=1, keepdims=True)
                        * 1.2 + 0.3, w[:, 1:]], axis=1).astype(dtype)
    eta_j, wbar_j = jax.jit(jcones._soc_nt)(s, z)
    eta, wbar = cones._soc_nt(torch.from_numpy(s), torch.from_numpy(z))
    eps = np.finfo(dtype).eps
    np.testing.assert_allclose(eta.numpy(), np.asarray(eta_j),
                               rtol=2 * eps, atol=0)
    np.testing.assert_allclose(wbar.numpy(), np.asarray(wbar_j),
                               rtol=0, atol=8 * eps)
