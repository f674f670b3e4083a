"""Port PDIP (the plain PyTorch version of the CUDA kernel) vs the JAX
package's solve_socp and its Pallas kernel in interpret mode, on the golden
pair batch and on one obstacle group of the quadrotor constraint batch.
Also the CUDA wrapper's refusals, which need no card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcol_tpu.ops.cones import ConeLayout as JLayout
from dcol_tpu.ops.pdip import solve_socp as jax_solve
from dcol_tpu.ops.pdip_pallas import solve_socp_pallas
from dcol_tpu.systems import quadrotor as jquad
from dcol_tpu_torch.ops import nvcc_build, pdip_cuda
from dcol_tpu_torch.ops.cones import ConeLayout
from dcol_tpu_torch.ops.pdip import solve_socp
from tests.test_pdip_pallas import _padded_batch

torch.set_num_threads(1)

# f64: the port and JAX run the same algorithm and every problem takes the
# same iteration count; x and z agree to ~1e-11.  s on the golden batch's
# padding rows is ill-determined at the stopping point: JAX's own XLA and
# Pallas paths differ there by up to 5e-7 (|s| ~ 12), so s is held to a
# relative 1e-6 instead of the absolute 1e-8.
ATOL = 1e-8
S_RTOL = 1e-6


def T(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _quad_group_batch():
    """The polygon-obstacle group (nv 6, 5 orthant rows, two SOC(4)) of the
    f64 quadrotor constraint batch at a perturbed Xref: 100 problems."""
    sys_, params, _, _, _ = jquad.make_problem(dtype=jnp.float64, backend="xla")
    rng = np.random.default_rng(7)
    X = np.asarray(params["Xref"]) + 0.3 * rng.normal(size=(sys_.N, sys_.nx))
    import jax
    rs, ps = jax.vmap(sys_.robot_pose)(jnp.asarray(X))
    scene = sys_.scene
    grouped = jax.vmap(lambda r, p: scene.assemble_groups(
        r, p, params["obs_r"], params["obs_p"]))(rs, ps)
    gi = [i for i, (lay, idx) in enumerate(scene.groups) if idx == (5,)][0]
    lay = scene.groups[gi][0]
    c, G, h = (np.asarray(a).reshape((-1,) + a.shape[2:]) for a in grouped[gi])
    return c, G, h, JLayout(lay.n_ort, lay.s1, lay.s2), 1e-6


def _golden():
    c, G, h, lay, _ = _padded_batch()
    return c, G, h, lay, 1e-9


BATCHES = {"golden": _golden, "quadrotor_group": _quad_group_batch}


@pytest.mark.parametrize("mode", ["cold", "warm", "warm_skip"])
@pytest.mark.parametrize("batch", list(BATCHES))
def test_plain_matches_jax_and_pallas(batch, mode):
    c, G, h, jlay, tol = BATCHES[batch]()
    lay = ConeLayout(jlay.n_ort, jlay.s1, jlay.s2)
    kw = dict(tol=tol, max_iters=40)
    jkw, tkw = {}, {}
    if mode != "cold":
        base = jax_solve(c, G, h, jlay, **kw)
        warm = tuple(np.asarray(a) for a in (base.x, base.s, base.z))
        G, h = G * (1 + 1e-3), h * (1 + 1e-3)
        jkw["warm"] = warm
        tkw["warm"] = tuple(T(a) for a in warm)
    if mode == "warm_skip":
        skip = np.arange(c.shape[0]) % 3 == 1
        jkw["skip"] = jnp.asarray(skip)
        tkw["skip"] = torch.as_tensor(skip)
    ref = jax_solve(c, G, h, jlay, **kw, **jkw)
    pal = solve_socp_pallas(c, G, h, jlay, **kw, **jkw, block=128,
                            interpret=True)
    got = solve_socp(T(c), T(G), T(h), lay, **kw, **tkw)
    for want in (ref, pal):
        for g, w, rtol in zip(got[:3], want[:3], (0, S_RTOL, 0)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                       atol=ATOL)
        np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
        np.testing.assert_array_equal(got.converged.numpy(),
                                      np.asarray(want.converged))
    if mode == "warm_skip":
        assert int(got.iters[tkw["skip"]].max()) == 0
        # skipped lanes return the warm-initialised iterate, not the raw warm
        np.testing.assert_array_equal(got.x[tkw["skip"]].numpy(),
                                      jkw["warm"][0][skip])
        assert not np.array_equal(got.s[tkw["skip"]].numpy(),
                                  jkw["warm"][1][skip])


def test_plain_golden_alphas_and_f32():
    """Golden alphas in f64 (rtol 1e-6) and the f32 settings of
    tests/test_pdip_pallas.py:50-58 (tol 2e-5, jitter 1e-6, rtol/atol 2e-3)."""
    c, G, h, jlay, gold = _padded_batch()
    lay = ConeLayout(jlay.n_ort, jlay.s1, jlay.s2)
    out = solve_socp(T(c), T(G), T(h), lay, tol=1e-9, max_iters=40)
    assert bool(out.converged.all())
    np.testing.assert_allclose(out.x[:, 3].numpy(), gold, rtol=1e-6, atol=1e-8)
    f32 = torch.float32
    out = solve_socp(T(c, f32), T(G, f32), T(h, f32), lay, tol=2e-5,
                     max_iters=40, jitter=1e-6)
    assert out.x.dtype == f32
    assert bool(out.converged.all())
    np.testing.assert_allclose(out.x[:, 3].numpy(), gold, rtol=2e-3, atol=2e-3)


def test_warm_start_takes_fewer_iterations():
    c, G, h, jlay, _ = _padded_batch()
    lay = ConeLayout(jlay.n_ort, jlay.s1, jlay.s2)
    cold = solve_socp(T(c), T(G), T(h), lay, tol=1e-9, max_iters=40)
    Gp, hp = T(G) * (1 + 1e-3), T(h) * (1 + 1e-3)
    cold2 = solve_socp(T(c), Gp, hp, lay, tol=1e-9, max_iters=40)
    warm2 = solve_socp(T(c), Gp, hp, lay, tol=1e-9, max_iters=40,
                       warm=(cold.x, cold.s, cold.z))
    assert bool(warm2.converged.all())
    np.testing.assert_allclose(warm2.x[:, 3].numpy(), cold2.x[:, 3].numpy(),
                               rtol=1e-6, atol=1e-7)
    assert float(warm2.iters.double().mean()) < float(
        cold2.iters.double().mean())


def test_nan_member_isolated():
    """A NaN problem must not perturb the other members and comes back
    converged=False (mirrors tests/test_robustness.py:59)."""
    c, G, h, jlay, gold = _padded_batch()
    lay = ConeLayout(jlay.n_ort, jlay.s1, jlay.s2)
    ref = solve_socp(T(c), T(G), T(h), lay, tol=1e-9, max_iters=40)
    c_p = c.copy()
    c_p[1] = np.nan
    out = solve_socp(T(c_p), T(G), T(h), lay, tol=1e-9, max_iters=40)
    assert not bool(out.converged[1])
    keep = np.array([i for i in range(c.shape[0]) if i != 1])
    np.testing.assert_array_equal(out.x.numpy()[keep], ref.x.numpy()[keep])
    np.testing.assert_allclose(out.x.numpy()[keep, 3], gold[keep], rtol=1e-6,
                               atol=1e-8)


def test_batched_equals_single():
    c, G, h, jlay, _ = _padded_batch()
    lay = ConeLayout(jlay.n_ort, jlay.s1, jlay.s2)
    batch = solve_socp(T(c), T(G), T(h), lay, tol=1e-9, max_iters=40)
    for i in range(c.shape[0]):
        one = solve_socp(T(c[i]), T(G[i]), T(h[i]), lay, tol=1e-9,
                         max_iters=40)
        # alpha as tightly as tests/test_pdip.py pins it; the contact point
        # (not unique on flat faces) to 1e-10
        np.testing.assert_allclose(float(one.x[3]), float(batch.x[i, 3]),
                                   rtol=1e-12)
        np.testing.assert_allclose(one.x.numpy(), batch.x[i].numpy(),
                                   rtol=0, atol=1e-10)
        assert int(one.iters) == int(batch.iters[i])


def test_skip_requires_warm():
    c, G, h, jlay, _ = _padded_batch()
    lay = ConeLayout(jlay.n_ort, jlay.s1, jlay.s2)
    skip = torch.zeros(c.shape[0], dtype=torch.bool)
    for solver in (solve_socp, pdip_cuda.solve_socp_cuda):
        with pytest.raises(ValueError, match="skip= requires warm="):
            solver(T(c), T(G), T(h), lay, skip=skip)


def test_cuda_wrapper_refuses_cpu_tensors_without_building():
    """The kernel's wrapper never falls back to the plain version: a CPU
    tensor raises before anything is built, so importing and calling it
    needs no nvcc."""
    c, G, h, jlay, _ = _padded_batch()
    lay = ConeLayout(jlay.n_ort, jlay.s1, jlay.s2)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pdip_cuda.solve_socp_cuda(T(c), T(G), T(h), lay)
    assert nvcc_build._LIBS == {} and nvcc_build._BUILDS == {}
    with pytest.raises(TypeError, match="float32/float64"):
        pdip_cuda._key(torch.float16, 4, lay)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card():
    """Kernel vs plain version on the card (skips without one): cold on the
    golden alphas, then warm and warm with every third lane skipped from
    the cold optimum on G, h x 1.001; equal iteration counts (f64), and the
    skipped lanes bit-identical to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    c, G, h, jlay, gold = _padded_batch()
    lay = ConeLayout(jlay.n_ort, jlay.s1, jlay.s2)
    dev = torch.device("cuda")
    args = [T(a).to(dev) for a in (c, G, h)]
    kw = dict(tol=1e-9, max_iters=40)
    n0 = pdip_cuda.launches
    out = pdip_cuda.solve_socp_cuda(*args, lay, **kw)
    ref = solve_socp(*args, lay, **kw)
    assert pdip_cuda.launches == n0 + 1
    np.testing.assert_allclose(out.x[:, 3].cpu().numpy(), gold, rtol=1e-6,
                               atol=1e-8)
    assert torch.equal(out.iters, ref.iters)
    warm = (ref.x, ref.s, ref.z)
    c2, G2, h2 = args[0], args[1] * (1 + 1e-3), args[2] * (1 + 1e-3)
    skip = torch.arange(c.shape[0], device=dev) % 3 == 1
    for sk in (None, skip):
        got = pdip_cuda.solve_socp_cuda(c2, G2, h2, lay, warm=warm, skip=sk,
                                        **kw)
        want = solve_socp(c2, G2, h2, lay, warm=warm, skip=sk, **kw)
        for g, w in zip(got[:3:2], want[:3:2]):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=0, atol=ATOL)
        assert torch.equal(got.iters, want.iters)
        assert torch.equal(got.converged, want.converged)
        if sk is not None:
            assert int(got.iters[sk].max()) == 0
            for g, w in zip(got[:3], want[:3]):
                assert torch.equal(g[sk], w[sk])
    assert pdip_cuda.launches == n0 + 3
