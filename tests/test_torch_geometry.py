"""Port geometry (dcol_tpu_torch.geometry) vs the reference goldens and vs the
JAX package on the same random poses (float64 on the CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcol_tpu.geometry import assembly as jasm
from dcol_tpu.geometry import mrp as jmrp
from dcol_tpu.geometry import primitives as jprim
from dcol_tpu_torch.geometry import assembly, primitives as prim
from dcol_tpu_torch.geometry.mrp import dcm_from_mrp, mrp_kinematics, skew
from tests.test_geometry import load

torch.set_num_threads(1)

# the goldens and tests/test_geometry.py use 1e-12; port vs JAX on the same
# f64 inputs differs only by summation order
ATOL = 1e-12
RTOL = 1e-12


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def golden_shapes(P=prim):
    """Shapes matching tools/gen_goldens.py make_prims()."""
    A, b = P.n_sided_polygon(5, 0.6)
    return {
        "polytope": P.rect_prism(2.5, 0.15, 0.01),
        "sphere": P.sphere(0.8),
        "cone": P.cone(2.0, np.deg2rad(22)),
        "capsule": P.capsule(0.2, 5.0),
        "cylinder": P.cylinder(0.6, 3.0),
        "polygon": P.polygon(A, b, 0.2),
    }


def all_kinds(P):
    """One shape of each of the 7 kinds (plus an offset body)."""
    s = golden_shapes(P)
    s["ellipsoid"] = P.ellipsoid(0.5, 0.8, 1.1)
    s["offset_sphere"] = P.sphere(0.3, r_offset=(0.1, -0.2, 0.05))
    return s


def test_dcm_matches_golden():
    for case in load("mrp.json"):
        np.testing.assert_allclose(dcm_from_mrp(T(case["p"])).numpy(),
                                   np.array(case["dcm"]), atol=ATOL)


def test_mrp_functions_match_jax_batched():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(4, 5, 3)) * 0.4
    w = rng.normal(size=(4, 5, 3))
    ref_dcm = jax.vmap(jax.vmap(jmrp.dcm_from_mrp))(p)
    ref_kin = jax.vmap(jax.vmap(jmrp.mrp_kinematics))(p, w)
    ref_skew = jax.vmap(jax.vmap(jmrp.skew))(p)
    np.testing.assert_allclose(dcm_from_mrp(T(p)).numpy(), ref_dcm,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mrp_kinematics(T(p), T(w)).numpy(), ref_kin,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(skew(T(p)).numpy(), ref_skew)


@pytest.mark.parametrize("kind", list(golden_shapes()))
def test_prim_blocks_match_golden(kind):
    gold = load("prim_blocks.json")[kind]
    G_ort, h_ort, G_soc, h_soc = assembly.prim_blocks(
        golden_shapes()[kind], T(gold["r"]), T(gold["p"]))
    for got, want in ((G_ort, gold["G_ort"]), (h_ort, gold["h_ort"]),
                      (G_soc, gold["G_soc"]), (h_soc, gold["h_soc"])):
        want = np.array(want)
        if want.size == 0:
            assert got.shape[0] == 0
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_padded_pair_matches_golden_rows():
    """The padded (c, G, h) restricted to real rows/cols equals the
    reference combined problem (mirrors tests/test_geometry.py)."""
    shapes = golden_shapes()
    for case in load("pairs.json"):
        s1, s2 = shapes[case["k1"]], shapes[case["k2"]]
        nv, n_ort = assembly.scene_dims(s1, [s2])
        lay = assembly.make_layout(s1, s2, nv, n_ort)
        c, G, h = (a.numpy() for a in assembly.assemble_pair(
            s1, s2, lay, T(case["r1"]), T(case["p1"]), T(case["r2"]),
            T(case["p2"])))
        Gr, hr = np.array(case["G"]), np.array(case["h"])
        v, n12 = lay.v, lay.n_ort1 + lay.n_ort2
        np.testing.assert_allclose(G[:n12, :v], Gr[:case["n_ort"]], atol=ATOL)
        np.testing.assert_allclose(h[:n12], hr[:case["n_ort"]], atol=ATOL)
        np.testing.assert_array_equal(G[:n12, v:], 0.0)
        r = case["n_ort"]
        if lay.soc1:
            np.testing.assert_allclose(G[n_ort:n_ort + lay.soc1, :v],
                                       Gr[r:r + lay.soc1], atol=ATOL)
            np.testing.assert_allclose(h[n_ort:n_ort + lay.soc1],
                                       hr[r:r + lay.soc1], atol=ATOL)
            r += lay.soc1
        if lay.soc2:
            base = n_ort + assembly.S_PAD
            np.testing.assert_allclose(G[base:base + lay.soc2, :v],
                                       Gr[r:r + lay.soc2], atol=ATOL)
        assert c[3] == 1.0 and np.count_nonzero(c) == 1
        fill0 = n12 + lay.n_box
        np.testing.assert_array_equal(G[fill0:n_ort], 0.0)
        np.testing.assert_array_equal(h[fill0:n_ort], 1.0)


@pytest.mark.parametrize("kind", list(all_kinds(prim)))
def test_assemble_pair_matches_jax(kind):
    """Port vs JAX assemble_pair, this kind as the first primitive against
    every kind as the second, exact and padded layouts, single and batched
    poses."""
    rng = np.random.default_rng(sorted(all_kinds(prim)).index(kind))
    port, ref = all_kinds(prim), all_kinds(jprim)
    for other in port:
        s1, s2 = port[kind], port[other]
        j1, j2 = ref[kind], ref[other]
        r1, p1, r2, p2 = (rng.normal(size=3) * 0.5 for _ in range(4))
        nv, n_ort = jasm.scene_dims(j1, [j2])
        layouts = [(assembly.exact_layout(s1, s2), jasm.exact_layout(j1, j2)),
                   (assembly.make_layout(s1, s2, nv + 1, n_ort + 3),
                    jasm.make_layout(j1, j2, nv + 1, n_ort + 3))]
        for lay, jlay in layouts:
            assert dataclasses.asdict(lay) == dataclasses.asdict(jlay)
            got = assembly.assemble_pair(s1, s2, lay, T(r1), T(p1), T(r2),
                                         T(p2))
            want = jasm.assemble_pair(j1, j2, jlay, r1, p1, r2, p2)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=RTOL, atol=ATOL)
        # batched robot poses against one obstacle pose
        R1 = rng.normal(size=(3, 4, 3))
        P1 = rng.normal(size=(3, 4, 3)) * 0.3
        lay, jlay = layouts[0]
        got = assembly.assemble_pair(s1, s2, lay, T(R1), T(P1), T(r2), T(p2))
        want = jax.vmap(jax.vmap(
            lambda a, b: jasm.assemble_pair(j1, j2, jlay, a, b, r2, p2)))(
                jnp.asarray(R1), jnp.asarray(P1))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


def test_mass_properties_match_jax_package():
    for fn, args in ((prim.rect_prism_mass, (2.5, 0.15, 0.01)),
                     (prim.cone_mass_properties, (prim.cone(2.0, 0.4),))):
        jfn = getattr(jprim, fn.__name__)
        jargs = tuple(jprim.cone(2.0, 0.4) if isinstance(a, prim.Shape) else a
                      for a in args)
        for g, w in zip(fn(*args), jfn(*jargs)):
            np.testing.assert_array_equal(g, w)


def test_port_imports_without_jax():
    """Every module of the port imports with jax and dcol_tpu unavailable."""
    import pkgutil
    import subprocess
    import sys

    import dcol_tpu_torch

    mods = [m.name for m in pkgutil.walk_packages(dcol_tpu_torch.__path__,
                                                  "dcol_tpu_torch.")]
    for m in ("ops.pdip_cuda", "ops.fma_peak", "ops.proximity",
              "solver.mpc", "systems.cone_through_wall", "tools.roofline"):
        assert "dcol_tpu_torch." + m in mods, m
    # and the roofline's CPU half runs: the FLOP tally of one PDIP layout
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'dcol_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "from dcol_tpu_torch.ops.cones import ConeLayout\n"
            "from dcol_tpu_torch.tools.roofline import pdip_work\n"
            "assert min(pdip_work(4, ConeLayout(12, 0, 0))) > 0\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
