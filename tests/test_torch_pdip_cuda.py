"""The PDIP kernel's wrapper on the CPU, with no card and no nvcc: the
arithmetic type and the team size for every layout the three systems and
the golden pairs solve (taken from the JAX package's scenes), the library
names and flags that carry both types, and the operands handed to the
kernel in the callers' own row-major tensors."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcol_tpu.systems import cone_through_wall as jcone
from dcol_tpu.systems import piano_mover as jpiano
from dcol_tpu.systems import quadrotor as jquad
from dcol_tpu_torch.geometry import primitives as prim
from dcol_tpu_torch.ops import nvcc_build, pdip_cuda
from dcol_tpu_torch.ops.cones import ConeLayout
from dcol_tpu_torch.ops.proximity import pair_layouts

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
GOLD = os.path.join(os.path.dirname(__file__), "goldens")


def _scene_layouts(mod):
    """(nv, ConeLayout) of every obstacle group of a JAX package system."""
    sys_ = mod.make_problem(dtype=jnp.float64)[0]
    return [(pl.nv, ConeLayout(pl.n_ort, pl.s1, pl.s2))
            for pl, _ in sys_.scene.groups]


def _layouts():
    """(nv, ConeLayout) of every obstacle group of the JAX package's three
    systems and of every golden pair."""
    out = []
    for mod in (jquad, jpiano, jcone):
        out += _scene_layouts(mod)
    A, b = prim.n_sided_polygon(5, 0.6)
    shapes = {"polytope": prim.rect_prism(2.5, 0.15, 0.01),
              "sphere": prim.sphere(0.8),
              "cone": prim.cone(2.0, np.deg2rad(22)),
              "capsule": prim.capsule(0.2, 5.0),
              "cylinder": prim.cylinder(0.6, 3.0),
              "polygon": prim.polygon(A, b, 0.2)}
    with open(os.path.join(GOLD, "pairs.json")) as f:
        for case in json.load(f):
            pl, cl = pair_layouts(shapes[case["k1"]], shapes[case["k2"]])
            out.append((pl.nv, cl))
    return list(dict.fromkeys(out))


def _lane_rows(lay: ConeLayout, team: int, lane: int):
    """The rows ``lane`` holds in csrc/pdip.cu's Team: orthant rows lane,
    lane + team, ...; then SOC block ``lane`` whole."""
    rows = list(range(lane, lay.n_ort, team))
    blocks = [(o, s) for o, s in ((lay.n_ort, lay.s1),
                                  (lay.n_ort + lay.s1, lay.s2)) if s]
    for o, s in blocks[lane:lane + 1]:
        rows += range(o, o + s)
    return rows


def _slots(lay: ConeLayout, team: int) -> int:
    """Register slots a lane holds: its orthant rows and, where the layout
    has a SOC block, max(s1, s2)."""
    has_soc = lay.s1 > 0 or lay.s2 > 0
    return -(-lay.n_ort // team) + has_soc * max(lay.s1, lay.s2)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_team_lanes_covers_every_layout(dtype):
    """For each layout: the team is a power of two from 2 to 32 (the
    kernel's static_assert) with T x slots >= nr, and the kernel's dealing
    of rows to lanes puts every row on exactly one lane."""
    layouts = _layouts()
    assert len(layouts) == 25  # 9 scene groups, 24 pair layouts; 8 shared
    for nv, lay in layouts:
        t = pdip_cuda.team_lanes(lay.nr, pdip_cuda.arith_dtype(dtype, lay))
        assert t in (2, 4, 8, 16, 32), (lay, t)
        assert t * _slots(lay, t) >= lay.nr, (lay, t)
        rows = sorted(r for lane in range(t) for r in _lane_rows(lay, t,
                                                                   lane))
        assert rows == list(range(lay.nr)), (lay, t, rows)
        assert all(len(_lane_rows(lay, t, lane)) <= _slots(lay, t)
                   for lane in range(t))
        assert pdip_cuda._key(dtype, nv, lay)[-1] == t


@pytest.mark.parametrize("system, layouts, arith", [
    (jquad, [(5, 4, 4, 4), (5, 2, 4, 4), (4, 0, 4, 4), (4, 1, 4, 3),
             (4, 8, 4, 0), (6, 5, 4, 4), (4, 6, 4, 0)], F64),
    (jcone, [(4, 7, 3, 0)], F64),
    (jpiano, [(4, 12, 0, 0)], F32),
], ids=["quadrotor", "cone", "piano"])
def test_arith_dtype_by_layout(system, layouts, arith):
    """A float32 launch iterates in float64 where its layout has a
    second-order-cone block (the quadrotor's 7 and the cone's), in float32
    where it has none (the piano's); the team is that of the arithmetic
    type (8 in float64, 4 in float32) and the key carries both types.  A
    float64 launch stays float64 (team 8), on every layout of the systems
    and the golden pairs."""
    got = _scene_layouts(system)
    assert [(nv, lay.n_ort, lay.s1, lay.s2) for nv, lay in got] == layouts
    for nv, lay in got:
        assert pdip_cuda.arith_dtype(F32, lay) == arith
        team = 8 if arith == F64 else 4
        assert pdip_cuda.team_lanes(lay.nr, arith) == team
        assert pdip_cuda._key(F32, nv, lay) == (
            "pdip", F32, arith, nv, lay.n_ort, lay.s1, lay.s2, team)
    for nv, lay in _layouts():
        assert pdip_cuda.arith_dtype(F64, lay) == F64
        assert pdip_cuda._key(F64, nv, lay)[2:] == (
            F64, nv, lay.n_ort, lay.s1, lay.s2, 8)


def test_build_names_both_types(monkeypatch):
    """The library's name and nvcc defines carry the storage and the
    arithmetic type, so the build cache cannot hand a float32-only library
    to a launch that iterates in float64; nothing is compiled here."""
    seen = []
    monkeypatch.setattr(pdip_cuda.nvcc_build, "build",
                        lambda *a: seen.append(a) or a)
    for dtype, lay in ((F32, ConeLayout(4, 4, 4)), (F32, ConeLayout(12, 0, 0)),
                       (F64, ConeLayout(4, 4, 4))):
        pdip_cuda.build(dtype, 5, lay)
    (k1, _, n1, d1), (k2, _, n2, d2), (k3, _, n3, d3) = seen
    assert n1 == "pdip_float_double_5_4_4_4_t8" and k1[1:3] == (F32, F64)
    assert "-DDCOL_T=float" in d1 and "-DDCOL_A=double" in d1
    assert "-DDCOL_TEAM=8" in d1
    assert n2 == "pdip_float_float_5_12_0_0_t4"
    assert "-DDCOL_A=float" in d2 and "-DDCOL_TEAM=4" in d2
    assert n3 == "pdip_double_double_5_4_4_4_t8"
    assert "-DDCOL_T=double" in d3 and "-DDCOL_A=double" in d3
    assert not any(k[0] == "pdip" for k in nvcc_build._BUILDS)


def test_key_refuses_other_dtypes():
    """Only float32 and float64 specialisations exist; anything else raises
    before a build."""
    lay = ConeLayout(4, 4, 4)
    for dt in (torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(TypeError, match="float32/float64"):
            pdip_cuda._key(dt, 5, lay)
    assert not any(k[0] == "pdip" for k in nvcc_build._BUILDS)


def _batch(B=10, nv=5, lay=ConeLayout(4, 4, 4)):
    rng = np.random.default_rng(0)
    T = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=F32)
    return T(B, nv), T(B, lay.nr, nv), T(B, lay.nr), (T(B, nv), T(B, lay.nr),
                                                      T(B, lay.nr))


@pytest.mark.parametrize("start", ["cold", "warm", "warm+skip"])
def test_operands_are_the_callers_tensors(start):
    """Contiguous operands reach the kernel as they are (same storage, no
    copy), in its order G, h, c, x, s, z, skip; absent ones as None."""
    c, G, h, warm = _batch()
    warm = None if start == "cold" else warm
    skip = (torch.arange(c.shape[0]) % 2 == 0 if start == "warm+skip"
            else None)
    ops = pdip_cuda.operands(c, G, h, warm, skip)
    want = [G, h, c] + (list(warm) if warm else [None] * 3) + [skip]
    assert len(ops) == 7
    for got, w in zip(ops, want):
        assert (got is None) == (w is None)
        if w is not None:
            assert got.data_ptr() == w.data_ptr() and got.is_contiguous()
    assert not any(k[0] == "pdip" for k in nvcc_build._BUILDS)


def test_operands_copy_only_strided_inputs():
    """A strided G becomes one contiguous copy with the same values; a
    scalar skip flag is broadcast to the batch; the others stay in place."""
    c, G, h, warm = _batch()
    Gt = G.transpose(1, 2).contiguous().transpose(1, 2)  # (B, nr, nv) view
    assert not Gt.is_contiguous()
    ops = pdip_cuda.operands(c, Gt, h, warm, torch.tensor(True))
    assert ops[0].is_contiguous() and ops[0].data_ptr() != Gt.data_ptr()
    assert torch.equal(ops[0], G)
    assert ops[2].data_ptr() == c.data_ptr()
    assert ops[6].shape == (c.shape[0],) and bool(ops[6].all())
