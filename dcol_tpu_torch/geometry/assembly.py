"""Assembly of per-primitive-pair SOCP problem matrices with static layouts.

Port of ``dcol_tpu/geometry/assembly.py:1-323``.  The layouts and padding are
the JAX package's (see its module docstring for why every padding row is a
real constraint of an equivalent SOCP):

  * exact minimal layouts per pair kind (:func:`exact_layout`) - the hot
    path; pairs grouped by layout batch with zero padding rows;
  * one padded layout covering every pair type of a scene
    (:func:`make_layout` defaults).

Poses are tensors with arbitrary (broadcastable) leading batch dims, and the
assembly is built functionally (``stack``/``cat``, no in-place writes) so
``torch.func.jvp`` goes through it for the envelope gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from dcol_tpu_torch.geometry import primitives as prim
from dcol_tpu_torch.geometry.mrp import dcm_from_mrp

S_PAD = 4  # padded SOC block size (max over kinds; see primitives.SOC_DIM)


def _const(vals, like: torch.Tensor, batch) -> torch.Tensor:
    """A pose-independent block, expanded over the batch shape."""
    t = torch.as_tensor(np.asarray(vals, dtype=np.float64), dtype=like.dtype,
                        device=like.device)
    return t.expand(tuple(batch) + t.shape)


def _world_pose(shape: prim.Shape, r, p):
    """World position and rotation of the shape after its rigid offset
    (identity offsets, the common case, skip the transform)."""
    Q = dcm_from_mrp(p)
    r_off = np.asarray(shape.r_offset, dtype=np.float64)
    Q_off = np.asarray(shape.Q_offset, dtype=np.float64)
    if not np.allclose(r_off, 0.0):
        ro = torch.as_tensor(r_off, dtype=r.dtype, device=r.device)
        r = r + (Q @ ro[:, None])[..., 0]
    if not np.allclose(Q_off, np.eye(3)):
        Q = Q @ torch.as_tensor(Q_off, dtype=r.dtype, device=r.device)
    return r, Q


def _mv(A, v):
    """A @ v over batch dims: A (..., n, k), v (..., k) -> (..., n)."""
    return (A @ v[..., :, None])[..., 0]


def prim_blocks(shape: prim.Shape, r, p):
    """(G_ort, h_ort, G_soc, h_soc) for one primitive at pose (r, p).

    r, p: (..., 3).  G_ort (..., n_ort, v), G_soc (..., n_soc, v) with
    v = 4 + extra vars (``problem_matrices.py:255-364`` in the reference)."""
    batch = torch.broadcast_shapes(r.shape[:-1], p.shape[:-1])
    r = r.expand(batch + (3,))
    p = p.expand(batch + (3,))
    rw, Q = _world_pose(shape, r, p)
    Qt = Q.transpose(-1, -2)
    k = shape.kind
    empty = lambda v: _const(np.zeros((0, v)), r, batch)
    empty_h = _const(np.zeros((0,)), r, batch)

    if k == prim.POLYTOPE:
        A = torch.as_tensor(shape.A_np(), dtype=r.dtype, device=r.device)
        AQt = A @ Qt                                   # (..., nf, 3)
        b = _const(-shape.b_np()[:, None], r, batch)
        return torch.cat([AQt, b], dim=-1), _mv(AQt, rw), empty(4), empty_h

    if k == prim.SPHERE:
        G_soc = _const([[0.0, 0.0, 0.0, -shape.R],
                        [-1.0, 0.0, 0.0, 0.0],
                        [0.0, -1.0, 0.0, 0.0],
                        [0.0, 0.0, -1.0, 0.0]], r, batch)
        h_soc = torch.cat([torch.zeros_like(rw[..., :1]), -rw], dim=-1)
        return empty(4), empty_h, G_soc, h_soc

    if k == prim.CONE:
        tb = np.tan(shape.beta)
        bx = Q[..., :, 0]
        EQt = torch.as_tensor([tb, 1.0, 1.0], dtype=r.dtype,
                              device=r.device)[:, None] * Qt
        h_soc = -_mv(EQt, rw)
        last = _const([[-tb * 3.0 * shape.H / 4.0], [0.0], [0.0]], r, batch)
        G_soc = torch.cat([-EQt, last], dim=-1)
        G_ort = torch.cat([bx, _const([-shape.H / 4.0], r, batch)],
                          dim=-1)[..., None, :]
        h_ort = torch.sum(bx * rw, dim=-1, keepdim=True)
        return G_ort, h_ort, G_soc, h_soc

    if k == prim.CAPSULE or k == prim.CYLINDER:
        bx = Q[..., :, 0]
        top = _const([[0.0, 0.0, 0.0, -shape.R, 0.0]], r, batch)
        bot = torch.cat([_const(np.hstack([-np.eye(3), np.zeros((3, 1))]),
                                r, batch), bx[..., :, None]], dim=-1)
        G_soc = torch.cat([top, bot], dim=-2)
        h_soc = torch.cat([torch.zeros_like(rw[..., :1]), -rw], dim=-1)
        hl = shape.L / 2.0
        cap_rows = _const([[0.0, 0.0, 0.0, -hl, 1.0],
                           [0.0, 0.0, 0.0, -hl, -1.0]], r, batch)
        if k == prim.CAPSULE:
            return cap_rows, _const([0.0, 0.0], r, batch), G_soc, h_soc
        tail = _const([-hl, 0.0], r, batch)
        r3 = torch.cat([-bx, tail], dim=-1)
        r4 = torch.cat([bx, tail], dim=-1)
        G_ort = torch.cat([cap_rows, r3[..., None, :], r4[..., None, :]],
                          dim=-2)
        bxr = torch.sum(bx * rw, dim=-1)
        z = torch.zeros_like(bxr)
        h_ort = torch.stack([z, z, -bxr, bxr], dim=-1)
        return G_ort, h_ort, G_soc, h_soc

    if k == prim.ELLIPSOID:
        P2 = torch.as_tensor(shape.A_np(), dtype=r.dtype, device=r.device)
        PQt = P2 @ Qt
        top = _const([[0.0, 0.0, 0.0, -1.0]], r, batch)
        bot = torch.cat([-PQt, _const(np.zeros((3, 1)), r, batch)], dim=-1)
        G_soc = torch.cat([top, bot], dim=-2)
        h_soc = torch.cat([torch.zeros_like(rw[..., :1]), -_mv(PQt, rw)],
                          dim=-1)
        return empty(4), empty_h, G_soc, h_soc

    if k == prim.POLYGON:
        A = shape.A_np()  # (nf, 2)
        nf = A.shape[0]
        G_ort = _const(np.hstack([np.zeros((nf, 3)), -shape.b_np()[:, None], A]),
                       r, batch)
        h_ort = _const(np.zeros(nf), r, batch)
        top = _const([[0.0, 0.0, 0.0, -shape.R, 0.0, 0.0]], r, batch)
        bot = torch.cat([_const(np.hstack([-np.eye(3), np.zeros((3, 1))]),
                                r, batch), Q[..., :, :2]], dim=-1)
        G_soc = torch.cat([top, bot], dim=-2)
        h_soc = torch.cat([torch.zeros_like(rw[..., :1]), -rw], dim=-1)
        return G_ort, h_ort, G_soc, h_soc

    raise ValueError(f"unknown primitive kind {k!r}")


# ---------------------------------------------------------------------------
# Pair layout + padded assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PairLayout:
    """Static layout of one primitive pair inside the padded problem.

    ``s1``/``s2`` are the PADDED SOC block sizes (0 = block absent); exact
    per-kind layouts (:func:`exact_layout`) set them to the true SOC dims."""

    n_ort1: int
    n_ort2: int
    v1: int
    v2: int
    soc1: int  # true SOC dims (0 if the primitive has no SOC block)
    soc2: int
    nv: int    # padded number of decision variables
    n_ort: int # padded number of orthant rows
    s1: int = S_PAD
    s2: int = S_PAD

    @property
    def v(self) -> int:
        return self.v1 + self.v2 - 4

    @property
    def n_box(self) -> int:
        return 2 * (self.nv - self.v)

    @property
    def nr(self) -> int:
        return self.n_ort + self.s1 + self.s2


def pair_min_dims(s1: prim.Shape, s2: prim.Shape) -> Tuple[int, int]:
    """(min decision vars, min orthant rows)."""
    return s1.n_vars + s2.n_vars - 4, s1.n_ort + s2.n_ort


def make_layout(s1: prim.Shape, s2: prim.Shape, nv: int, n_ort: int,
                s1_pad: int = S_PAD, s2_pad: int = S_PAD) -> PairLayout:
    lay = PairLayout(
        n_ort1=s1.n_ort, n_ort2=s2.n_ort, v1=s1.n_vars, v2=s2.n_vars,
        soc1=s1.n_soc, soc2=s2.n_soc, nv=nv, n_ort=n_ort,
        s1=s1_pad, s2=s2_pad,
    )
    if lay.v > nv:
        raise ValueError(f"{lay}: needs {lay.v} columns, layout has {nv}")
    if lay.n_ort1 + lay.n_ort2 + lay.n_box > n_ort:
        raise ValueError(f"{lay}: orthant rows do not fit in {n_ort}")
    if lay.soc1 > lay.s1 or lay.soc2 > lay.s2:
        raise ValueError(f"{lay}: SOC block larger than its padded size")
    return lay


def exact_layout(s1: prim.Shape, s2: prim.Shape) -> PairLayout:
    """Minimal zero-padding layout for one pair (exact columns, exact orthant
    rows, exact SOC dims with absent blocks dropped)."""
    v, rows = pair_min_dims(s1, s2)
    return make_layout(s1, s2, v, rows, s1_pad=s1.n_soc, s2_pad=s2.n_soc)


def scene_dims(robot: prim.Shape, obstacles: Sequence[prim.Shape]) -> Tuple[int, int]:
    """Unified (NV, N_ORT) covering every robot-obstacle pair of a scene."""
    nv = max(pair_min_dims(robot, o)[0] for o in obstacles)
    n_ort = 0
    for o in obstacles:
        v, rows = pair_min_dims(robot, o)
        n_ort = max(n_ort, rows + 2 * (nv - v))
    return nv, n_ort


def assemble_pair(s1: prim.Shape, s2: prim.Shape, layout: PairLayout,
                  r1, p1, r2, p2):
    """Padded (c, G, h) for the pair SOCP:  min c'x  s.t.  Gx + s = h, s in K.

    K = R^{n_ort}_+ x SOC(layout.s1) x SOC(layout.s2), zero-size blocks
    dropped.  The four poses are (..., 3) with broadcastable batch dims;
    returns c (..., nv), G (..., nr, nv), h (..., nr)."""
    batch = torch.broadcast_shapes(r1.shape[:-1], p1.shape[:-1],
                                   r2.shape[:-1], p2.shape[:-1])
    G1o, h1o, G1s, h1s = prim_blocks(s1, r1, p1)
    G2o, h2o, G2s, h2s = prim_blocks(s2, r2, p2)
    L = layout
    nv, n_ort = L.nv, L.n_ort
    like = r1

    def bexp(a, tail):
        return a.expand(batch + tuple(tail))

    def zeros(*shape):
        return _const(np.zeros(shape), like, batch)

    def embed_cols(B, which: int):
        """Map a block's local columns into the padded column layout."""
        n = B.shape[-2]
        B = bexp(B, B.shape[-2:])
        if which == 1:
            parts = [B, zeros(n, nv - L.v1)]
        else:
            parts = [B[..., :4], zeros(n, L.v1 - 4), B[..., 4:],
                     zeros(n, nv - L.v)]
        return torch.cat([q for q in parts if q.shape[-1]], dim=-1)

    rows = [embed_cols(G1o, 1), embed_cols(G2o, 2)]
    hs = [bexp(h1o, h1o.shape[-1:]), bexp(h2o, h2o.shape[-1:])]
    # box rows for padded decision columns: +/- x_j <= 1
    for j in range(L.v, nv):
        e = np.zeros((2, nv))
        e[0, j], e[1, j] = 1.0, -1.0
        rows.append(_const(e, like, batch))
        hs.append(_const([1.0, 1.0], like, batch))
    # vacuous fill rows: 0 x <= 1
    n_fill = n_ort - (L.n_ort1 + L.n_ort2 + L.n_box)
    if n_fill:
        rows.append(zeros(n_fill, nv))
        hs.append(_const(np.ones(n_fill), like, batch))

    def soc_block(Gs, hsv, which: int, true_dim: int, pad_dim: int):
        if pad_dim == 0:  # block absent from the layout entirely
            return None
        if true_dim == 0:  # vacuous SOC: 0 x + s = e1
            e1 = np.zeros(pad_dim)
            e1[0] = 1.0
            return zeros(pad_dim, nv), _const(e1, like, batch)
        Gp = torch.cat([embed_cols(Gs, which),
                        zeros(pad_dim - true_dim, nv)], dim=-2)
        hp = torch.cat([bexp(hsv, hsv.shape[-1:]),
                        zeros(pad_dim - true_dim)], dim=-1)
        return Gp, hp

    for blk in (soc_block(G1s, h1s, 1, L.soc1, L.s1),
                soc_block(G2s, h2s, 2, L.soc2, L.s2)):
        if blk is not None:
            rows.append(blk[0])
            hs.append(blk[1])

    G = torch.cat(rows, dim=-2)
    h = torch.cat(hs, dim=-1)
    c = np.zeros(nv)
    c[3] = 1.0
    return _const(c, like, batch), G, h
