"""The PDIP kernel's wrapper on the CPU, with no card and no nvcc: the team
size for every layout the three systems and the golden pairs solve (taken
from the JAX package's scenes), and the operands handed to the kernel in
the callers' own row-major tensors."""

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


def _layouts():
    """(nv, ConeLayout) of every obstacle group of the JAX package's three
    systems and of every golden pair."""
    out = []
    for mod in (jquad, jpiano, jcone):
        sys_ = mod.make_problem(dtype=jnp.float64)[0]
        out += [(pl.nv, ConeLayout(pl.n_ort, pl.s1, pl.s2))
                for pl, _ in sys_.scene.groups]
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
        t = pdip_cuda.team_lanes(lay.nr, dtype)
        assert t in (2, 4, 8, 16, 32), (lay, t)
        assert t * _slots(lay, t) >= lay.nr, (lay, t)
        rows = sorted(r for lane in range(t) for r in _lane_rows(lay, t,
                                                                   lane))
        assert rows == list(range(lay.nr)), (lay, t, rows)
        assert all(len(_lane_rows(lay, t, lane)) <= _slots(lay, t)
                   for lane in range(t))
        assert pdip_cuda._key(dtype, nv, lay)[-1] == t


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
