"""Port proximity API vs the reference finite-difference goldens and the JAX
package (float64 on the CPU): alpha and envelope gradients on the 27 golden
pairs, the autograd Function against the direct gradient, batched against
single, and agreement with JAX's proximity_with_grad on random poses
(mirrors tests/test_proximity.py)."""

import json
import os

import numpy as np
import pytest
import torch

from dcol_tpu.geometry import primitives as jprim
from dcol_tpu.ops.proximity import proximity_with_grad as jproximity_with_grad
from dcol_tpu_torch.geometry import primitives as prim
from dcol_tpu_torch.ops.proximity import (
    pair_layouts, proximity, proximity_alpha, proximity_with_grad)

torch.set_num_threads(1)

F64 = torch.float64
GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def shapes(P):
    """The golden shapes (tools/gen_goldens.py make_prims()) from the
    primitives module P of either package."""
    A, b = P.n_sided_polygon(5, 0.6)
    return {
        "polytope": P.rect_prism(2.5, 0.15, 0.01),
        "sphere": P.sphere(0.8),
        "cone": P.cone(2.0, np.deg2rad(22)),
        "capsule": P.capsule(0.2, 5.0),
        "cylinder": P.cylinder(0.6, 3.0),
        "polygon": P.polygon(A, b, 0.2),
    }


def cases():
    with open(os.path.join(GOLD, "pairs.json")) as f:
        return json.load(f)


def poses(case, **kw):
    return [torch.tensor(case[k], dtype=F64, **kw)
            for k in ("r1", "p1", "r2", "p2")]


def test_alpha_and_envelope_grad_match_reference():
    """alpha to rtol 1e-6 / atol 1e-8 and the envelope gradients to the
    reference's central differences (eps ~1.5e-8, so ~1e-6 error): rtol
    2e-4, atol 5e-5, as tests/test_proximity.py."""
    sh = shapes(prim)
    for case in cases():
        s1, s2 = sh[case["k1"]], sh[case["k2"]]
        res, grads = proximity_with_grad(s1, s2, *poses(case),
                                         argnums=(0, 1, 2, 3), tol=1e-10,
                                         max_iters=40)
        assert bool(res.converged)
        np.testing.assert_allclose(float(res.alpha), case["alpha"],
                                   rtol=1e-6, atol=1e-8)
        got = torch.cat(grads).numpy()
        np.testing.assert_allclose(got, np.array(case["grad"]), rtol=2e-4,
                                   atol=5e-5,
                                   err_msg=f"{case['k1']} vs {case['k2']}")


def test_autograd_matches_direct_grad():
    """``proximity_alpha(...).backward()`` gives proximity_with_grad's
    gradients for all four poses (rtol 1e-9)."""
    sh = shapes(prim)
    case = cases()[3]
    s1, s2 = sh[case["k1"]], sh[case["k2"]]
    leaves = poses(case, requires_grad=True)
    a = proximity_alpha(s1, s2, *leaves, tol=1e-10, max_iters=40)
    assert a.shape == () and a.requires_grad
    a.backward()
    _, grads = proximity_with_grad(s1, s2, *poses(case),
                                   argnums=(0, 1, 2, 3), tol=1e-10,
                                   max_iters=40)
    for leaf, g in zip(leaves, grads):
        np.testing.assert_allclose(leaf.grad.numpy(), g.numpy(), rtol=1e-9)
    # a cotangent other than 1 scales the gradients
    leaves2 = poses(case, requires_grad=True)
    (3.0 * proximity_alpha(s1, s2, *leaves2, tol=1e-10,
                           max_iters=40)).backward()
    np.testing.assert_allclose(leaves2[0].grad.numpy(),
                               3.0 * grads[0].numpy(), rtol=1e-9)


def test_batched_matches_single():
    """Batched poses equal the single-pose path (rtol 1e-12, as
    tests/test_proximity.py), and the autograd gradient of a batch equals
    each member's own gradient (rtol 1e-8); a pose shared by the batch
    gets the batch's summed gradient."""
    sh = shapes(prim)
    s1, s2 = sh["sphere"], sh["cylinder"]
    layouts = pair_layouts(s1, s2)
    rng = np.random.default_rng(7)
    r1 = torch.tensor(rng.standard_normal((16, 3)) * 1.5)
    p1 = torch.tensor(rng.standard_normal((16, 3)) * 0.3)
    r2 = torch.tensor([3.0, 0.5, 0.2], dtype=F64)
    p2 = torch.tensor([0.1, -0.2, 0.3], dtype=F64)
    batched = proximity(s1, s2, r1, p1, r2, p2, layouts=layouts, tol=1e-9,
                        max_iters=40)
    assert batched.alpha.shape == (16,) and bool(batched.converged.all())
    for i in range(0, 16, 5):
        single = proximity(s1, s2, r1[i], p1[i], r2, p2, layouts=layouts,
                           tol=1e-9, max_iters=40)
        np.testing.assert_allclose(float(batched.alpha[i]),
                                   float(single.alpha), rtol=1e-12)

    r1g = r1.clone().requires_grad_(True)
    r2g = r2.clone().requires_grad_(True)
    a = proximity_alpha(s1, s2, r1g, p1, r2g, p2, layouts=layouts, tol=1e-9,
                        max_iters=40)
    a.sum().backward()
    shared = torch.zeros(3, dtype=F64)
    for i in range(16):
        _, (g1, g3) = proximity_with_grad(s1, s2, r1[i], p1[i], r2, p2,
                                          layouts=layouts, argnums=(0, 2),
                                          tol=1e-9, max_iters=40)
        np.testing.assert_allclose(r1g.grad[i].numpy(), g1.numpy(),
                                   rtol=1e-8, atol=1e-12)
        shared += g3
    np.testing.assert_allclose(r2g.grad.numpy(), shared.numpy(), rtol=1e-8,
                               atol=1e-12)


@pytest.mark.parametrize("pair", [("sphere", "polytope"), ("cone", "capsule"),
                                  ("polygon", "cylinder"),
                                  ("polytope", "polytope")])
def test_matches_jax_on_random_poses(pair):
    """alpha and all four gradients equal JAX's proximity_with_grad on
    random poses (f64, tol 1e-10: the same iterations on both sides, so
    rounding only: atol 1e-8)."""
    sh, jsh = shapes(prim), shapes(jprim)
    s1, s2 = sh[pair[0]], sh[pair[1]]
    rng = np.random.default_rng(11)
    for _ in range(3):
        r1, r2 = rng.normal(size=3) * 2.0, rng.normal(size=3) * 2.0
        p1, p2 = rng.normal(size=3) * 0.3, rng.normal(size=3) * 0.3
        res, grads = proximity_with_grad(
            s1, s2, *[torch.tensor(a) for a in (r1, p1, r2, p2)],
            argnums=(0, 1, 2, 3), tol=1e-10, max_iters=40)
        jres, jgrads = jproximity_with_grad(
            jsh[pair[0]], jsh[pair[1]], r1, p1, r2, p2,
            argnums=(0, 1, 2, 3), tol=1e-10, max_iters=40)
        assert bool(res.converged) == bool(jres.converged)
        assert int(res.iters) == int(jres.iters)
        np.testing.assert_allclose(float(res.alpha), float(jres.alpha),
                                   rtol=0, atol=1e-8)
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                                       atol=1e-8)


@pytest.mark.cuda
def test_golden_pairs_on_card():
    """proximity_alpha on the card through the PDIP kernel (skips without
    one): alpha and the backward gradients against the goldens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    sh = shapes(prim)
    for case in cases():
        leaves = [p.cuda().requires_grad_(True) for p in poses(case)]
        a = proximity_alpha(sh[case["k1"]], sh[case["k2"]], *leaves,
                            tol=1e-10, max_iters=40)
        a.backward()
        np.testing.assert_allclose(float(a), case["alpha"], rtol=1e-6,
                                   atol=1e-8)
        got = torch.cat([p.grad for p in leaves]).cpu().numpy()
        np.testing.assert_allclose(got, np.array(case["grad"]), rtol=2e-4,
                                   atol=5e-5)
