"""Port collision scene and systems vs the JAX package (float64 on the CPU):
quadrotor obstacle groups, constraint values and Jacobian rows along a
trajectory, grouped vs per-pair proximity, envelope gradients vs finite
differences, and the dynamics and their Jacobians."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcol_tpu.ops.proximity import proximity
from dcol_tpu.solver import altro as jaltro
from dcol_tpu.systems import cone_through_wall as jcone
from dcol_tpu.systems import piano_mover as jpiano
from dcol_tpu.systems import quadrotor as jquad
from dcol_tpu_torch.convert import params_from_numpy, warm_from_numpy
from dcol_tpu_torch.geometry import primitives as prim
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.systems import cone_through_wall, piano_mover, quadrotor
from dcol_tpu_torch.systems.base import CollisionScene, ProximityOptions

torch.set_num_threads(1)

F64 = torch.float64
# f64: same PDIP iterations on both sides, iterates equal to rounding
ATOL = 1e-8


def T(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _quad():
    jsys, jparams, X0, U0, _ = jquad.make_problem(dtype=jnp.float64,
                                                  backend="xla")
    sys_, params, _, _, _ = quadrotor.make_problem(F64, "cpu")
    return jsys, jparams, sys_, params


def test_quadrotor_groups_and_layouts():
    """7 groups with the layouts of docs/PROFILE.md's table (nv, n_ort,
    s1, s2), identical to the JAX package's."""
    jsys, _, sys_, _ = _quad()
    got = [((lay.nv, lay.n_ort, lay.s1, lay.s2), idx)
           for lay, idx in sys_.scene.groups]
    assert got == [((5, 4, 4, 4), (0, 6)), ((5, 2, 4, 4), (1, 7)),
                   ((4, 0, 4, 4), (2, 8)), ((4, 1, 4, 3), (3,)),
                   ((4, 8, 4, 0), (4,)), ((6, 5, 4, 4), (5,)),
                   ((4, 6, 4, 0), (9, 10))]
    assert got == [((lay.nv, lay.n_ort, lay.s1, lay.s2), idx)
                   for lay, idx in jsys.scene.groups]
    assert sys_.scene.inv_perm == jsys.scene.inv_perm


@pytest.mark.parametrize("where", ["xref", "perturbed"])
def test_constraints_match_jax(where):
    """constraints_x_traj (cold, then warm) and constraints_x_vg_traj (the
    polish path: values and dh/dx rows) at Xref and at a perturbed X."""
    jsys, jparams, sys_, params = _quad()
    X = np.asarray(jparams["Xref"])
    if where == "perturbed":
        X = X + 0.2 * np.random.default_rng(1).normal(size=X.shape)
    pb = {k: v[None] for k, v in params.items()}
    Xt = T(X)[None]

    hj, wj = jax.jit(lambda X_: jsys.constraints_x_traj(jparams, X_))(X)
    h, w = sys_.constraints_x_traj(pb, Xt)
    np.testing.assert_allclose(h[0].numpy(), np.asarray(hj), rtol=0, atol=ATOL)
    for g, gj in zip(w, wj):
        for a, aj in zip(g, gj):
            assert a[0].shape == aj.shape

    # warm re-solve at a nearby trajectory, from each package's own warm
    X2 = X + 1e-3
    hj2, _ = jax.jit(lambda X_, w_: jsys.constraints_x_traj(
        jparams, X_, warm=w_))(X2, wj)
    h2, _ = sys_.constraints_x_traj(pb, T(X2)[None], warm=w)
    np.testing.assert_allclose(h2[0].numpy(), np.asarray(hj2), rtol=0,
                               atol=ATOL)

    # polish: warm start from the JAX solution at X, converted
    wt = warm_from_numpy(tuple(tuple(np.asarray(a)[None] for a in g)
                               for g in wj), device="cpu", dtype=F64)
    hj3, rj3, _ = jax.jit(lambda X_, w_: jsys.constraints_x_vg_traj(
        jparams, X_, warm=w_))(X, wj)
    h3, r3, _ = sys_.constraints_x_vg_traj(pb, Xt, warm=wt)
    np.testing.assert_allclose(h3[0].numpy(), np.asarray(hj3), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(r3[0].numpy(), np.asarray(rj3), rtol=0,
                               atol=ATOL)
    # cold value-and-gradient path
    hj4, rj4, _ = jax.jit(lambda X_: jsys.constraints_x_vg_traj(
        jparams, X_))(X)
    h4, r4, _ = sys_.constraints_x_vg_traj(pb, Xt)
    np.testing.assert_allclose(r4[0].numpy(), np.asarray(rj4), rtol=0,
                               atol=ATOL)


def _mixed_scene():
    # deliberately INTERLEAVED kinds so grouped order != obstacle order
    # (tests/test_groups.py)
    robot = prim.sphere(0.3)
    obstacles = (
        prim.sphere(0.8),               # group A
        prim.rect_prism(1.0, 2.0, 0.5), # group B
        prim.sphere(0.5),               # group A again
        prim.capsule(0.2, 1.5),         # group C
        prim.rect_prism(0.7, 0.7, 0.7), # group B again
    )
    scene = CollisionScene(robot, obstacles, ProximityOptions(1e-8, 40))
    obs_r = np.array([[2.0, 0.0, 0.0], [0.0, 3.0, 0.5], [-2.5, 1.0, 0.0],
                      [1.0, -2.0, 1.0], [0.5, 0.5, -3.0]])
    obs_p = np.array([[0.0, 0.0, 0.0], [0.1, -0.2, 0.05], [0.0, 0.0, 0.0],
                      [0.3, 0.1, 0.0], [-0.1, 0.2, 0.1]])
    return scene, obs_r, obs_p


def test_groups_partition_and_layouts():
    scene, _, _ = _mixed_scene()
    assert [idx for _, idx in scene.groups] == [(0, 2), (1, 4), (3,)]
    inv = scene.inv_perm
    assert [scene.group_order[i] for i in inv] == list(range(scene.n_obs))
    lay_ss, lay_sp = scene.groups[0][0], scene.groups[1][0]
    assert (lay_ss.n_ort, lay_ss.s1, lay_ss.s2, lay_ss.nv) == (0, 4, 4, 4)
    assert (lay_sp.n_ort, lay_sp.s1, lay_sp.s2, lay_sp.nv) == (6, 4, 0, 4)


def test_grouped_alphas_match_per_pair():
    """Grouped solves in obstacle order equal the JAX package's per-pair
    proximity (rtol 1e-6 at tol 1e-8, as tests/test_groups.py); a warm
    restart reproduces them (rtol 1e-5)."""
    scene, obs_r, obs_p = _mixed_scene()
    rs = np.array([[0.0, 0.0, 0.0], [0.5, 0.2, -0.1]])
    ps = np.array([[0.0, 0.0, 0.0], [0.05, -0.1, 0.2]])
    a, warm = scene.alphas_traj(T(rs)[None], T(ps)[None], T(obs_r)[None],
                                T(obs_p)[None])
    assert a.shape == (1, 2, scene.n_obs)
    from dcol_tpu.geometry import primitives as jprim
    jobs = (jprim.sphere(0.8), jprim.rect_prism(1.0, 2.0, 0.5),
            jprim.sphere(0.5), jprim.capsule(0.2, 1.5),
            jprim.rect_prism(0.7, 0.7, 0.7))
    for t in range(2):
        for i, o in enumerate(jobs):
            ref = proximity(jprim.sphere(0.3), o, rs[t], ps[t], obs_r[i],
                            obs_p[i], tol=1e-10, max_iters=50)
            np.testing.assert_allclose(float(a[0, t, i]), float(ref.alpha),
                                       rtol=1e-6)
    assert len(warm) == len(scene.groups)
    a2, _ = scene.alphas_traj(T(rs)[None], T(ps)[None], T(obs_r)[None],
                              T(obs_p)[None], warm=warm)
    np.testing.assert_allclose(a2.numpy(), a.numpy(), rtol=1e-5)


def test_grouped_envelope_grads_match_fd():
    """Envelope gradients vs central differences (eps 1e-6; rtol 2e-3,
    atol 2e-5, as tests/test_groups.py)."""
    scene, obs_r, obs_p = _mixed_scene()
    rs = T([[[0.1, -0.2, 0.3]]])
    ps = T([[[0.02, 0.05, -0.04]]])
    orr, opp = T(obs_r)[None], T(obs_p)[None]
    _, d_r, d_p, _ = scene.alphas_and_grads_traj(rs, ps, orr, opp)
    eps = 1e-6
    for j in range(3):
        e = torch.zeros(3, dtype=F64)
        e[j] = eps
        for d, args in ((d_r, lambda s: (rs + s * e, ps)),
                        (d_p, lambda s: (rs, ps + s * e))):
            ap, _ = scene.alphas_traj(*args(1.0), orr, opp)
            am, _ = scene.alphas_traj(*args(-1.0), orr, opp)
            np.testing.assert_allclose(d[0, 0, :, j].numpy(),
                                       ((ap - am)[0, 0] / (2 * eps)).numpy(),
                                       rtol=2e-3, atol=2e-5)


@pytest.mark.parametrize("system", ["quadrotor", "piano_mover", "cone"])
def test_dynamics_and_jacobians_match_jax(system):
    """RK4 step and its forward-mode Jacobians vs the JAX package's
    (f64, rtol 1e-12 / atol 1e-12: same formulas, summation order only)."""
    jmod, mod = {"quadrotor": (jquad, quadrotor),
                 "piano_mover": (jpiano, piano_mover),
                 "cone": (jcone, cone_through_wall)}[system]
    jsys, jparams, _, _, _ = jmod.make_problem(dtype=jnp.float64,
                                               backend="xla")
    sys_, params, _, _, _ = mod.make_problem(F64, "cpu")
    rng = np.random.default_rng(2)
    X = rng.normal(size=(2, 5, sys_.nx)) * 0.5
    U = rng.normal(size=(2, 5, sys_.nu)) + 1.0
    pb = params_from_numpy({k: np.asarray(v)[None].repeat(2, 0)
                            for k, v in jparams.items()}, device="cpu",
                           dtype=F64)
    f = jax.vmap(jax.vmap(lambda x, u: jsys.discrete_dynamics(jparams, x, u,
                                                              0)))
    np.testing.assert_allclose(
        sys_.discrete_dynamics(pb, T(X), T(U)).numpy(), np.asarray(f(X, U)),
        rtol=1e-12, atol=1e-12)
    A, B = altro.dynamics_jacobians(sys_, pb, T(X), T(U))
    Aj, Bj = jax.vmap(jax.vmap(jax.jacfwd(
        lambda x, u: jsys.discrete_dynamics(jparams, x, u, 0),
        argnums=(0, 1))))(X, U)
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(B.numpy(), np.asarray(Bj), rtol=1e-12,
                               atol=1e-12)


def test_cost_terms_match_jax():
    """quad_cost and al_cost on random duals and constraint values,
    including a candidate dim (S, C, N, nx)."""
    jsys, jparams, sys_, params = _quad()
    rng = np.random.default_rng(3)
    N, nx, nu = sys_.N, sys_.nx, sys_.nu
    X = np.asarray(jparams["Xref"]) + rng.normal(size=(N, nx)) * 0.1
    U = rng.normal(size=(N - 1, nu))
    hx = rng.normal(size=(N, sys_.ncx)) * 0.1
    hu = rng.normal(size=(N - 1, sys_.ncu))
    mu = np.abs(rng.normal(size=(N - 1, sys_.ncu)))
    mux = np.abs(rng.normal(size=(N, sys_.ncx)))
    lam = rng.normal(size=nx)
    want = float(jaltro.total_cost(jsys, jparams, X, U, hx, hu, mu, mux, lam,
                                   10.0))
    pb = {k: v[None] for k, v in params.items()}
    got = altro.total_cost(sys_, pb, T(X)[None, None].repeat(1, 2, 1, 1),
                           T(U)[None, None].repeat(1, 2, 1, 1),
                           T(hx)[None, None].repeat(1, 2, 1, 1),
                           T(hu)[None, None].repeat(1, 2, 1, 1), T(mu)[None],
                           T(mux)[None], T(lam)[None], T([10.0]))
    assert got.shape == (1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
