"""Plain reference solver for the proximity problems of a scene.

The proximity value alpha of a robot shape and an obstacle (Tracy, Howell,
Manchester, arXiv:2207.00669) is the least uniform scaling of both shapes,
each about its own centre, at which they touch:

    min alpha  s.t.  x in r1 + alpha Q1 S1,  x in r2 + alpha Q2 S2.

Each shape's membership is written here in its body frame, y = Q'(x - r),
as conic rows  h - G z in K  over z = [x (3), alpha, extra variables], and
the conic program is solved by a dense primal-dual interior-point method
(Nesterov-Todd scaling, Mehrotra predictor-corrector) batched over
problems.  Nothing here comes from the program under test: the shapes come
from the configuration file, the formulation and the solver are this
file's own.

``Arith`` sets the precision: float64 for the reference, and for the
control float32 with every matrix product's operands rounded to TF32
(10 mantissa bits), the precision the configuration turns off.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Arith:
    """The arithmetic of a reference computation."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def round(self, a: torch.Tensor) -> torch.Tensor:
        """``a`` in this arithmetic's storage (TF32 operands: float32 with
        the low 13 mantissa bits rounded off, to nearest)."""
        a = a.to(self.dtype)
        if not self.tf32:
            return a
        bits = a.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A matrix product in this arithmetic."""
        if self.tf32:
            return self.round(a) @ self.round(b)
        return a.to(self.dtype) @ b.to(self.dtype)

    def mv(self, A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.mm(A, v[..., None])[..., 0]


REF = Arith(torch.float64, False)
CONTROL = Arith(torch.float32, True)


def dcm_from_mrp(p: torch.Tensor, ar: Arith = REF) -> torch.Tensor:
    """Rotation matrix of modified Rodrigues parameters p (..., 3):
    I + (8 [p]x^2 + 4 (1 - p'p) [p]x) / (1 + p'p)^2."""
    p = p.to(ar.dtype)
    z = torch.zeros_like(p[..., 0])
    S = torch.stack([torch.stack([z, -p[..., 2], p[..., 1]], -1),
                     torch.stack([p[..., 2], z, -p[..., 0]], -1),
                     torch.stack([-p[..., 1], p[..., 0], z], -1)], -2)
    pp = (p * p).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=ar.dtype, device=p.device)
    return eye + (8.0 * ar.mm(S, S) + 4.0 * (1.0 - pp) * S) / (1.0 + pp) ** 2


# ---------------------------------------------------------------------------
# Conic rows of one shape, in its body frame
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rows:
    """Rows h - G z of one cone block over the pair's variables z."""

    G: torch.Tensor   # (B, m, n)
    h: torch.Tensor   # (B, m)
    soc: bool         # a second-order-cone block (else orthant rows)


def shape_rows(shape: dict, r, Q, n: int, extra: int,
               ar: Arith = REF) -> List[Rows]:
    """Cone blocks of ``x in r + alpha Q S`` for one shape of the
    configuration file (``kind`` and its sizes), at world pose (r (B, 3),
    Q (B, 3, 3)); its extra variables start at column ``extra`` of z."""
    dt, dev = ar.dtype, r.device
    B = r.shape[0]
    Qt = Q.transpose(-1, -2).to(dt)
    # y = Q'(x - r) = hy - Gy z with Gy = [-Q', 0] and hy = -Q' r
    Gy = torch.zeros((B, 3, n), dtype=dt, device=dev)
    Gy[:, :, :3] = -Qt
    Gy = ar.round(Gy)
    hy = ar.round(-ar.mv(Qt, r.to(dt)))
    kind = shape["kind"]

    def rows(coef_alpha, lin_y, lin_extra=None):
        """Rows  a alpha + L y + E w  as h - G z:  h = L hy,
        G = L Gy - a e_alpha - E e_w."""
        L = torch.as_tensor(np.asarray(lin_y, np.float64), dtype=dt,
                            device=dev).expand(B, -1, 3)
        G = ar.mm(L, Gy).clone()
        h = ar.mv(L, hy)
        G[:, :, 3] -= torch.as_tensor(np.asarray(coef_alpha, np.float64),
                                      dtype=dt, device=dev)
        if lin_extra is not None:
            E = torch.as_tensor(np.asarray(lin_extra, np.float64), dtype=dt,
                                device=dev)
            G[:, :, extra:extra + E.shape[1]] -= E
        return G, h

    eye = np.eye(3)
    if kind == "polytope":
        A, b = np.asarray(shape["A"]), np.asarray(shape["b"])
        G, h = rows(b, -A)                        # b alpha - A y >= 0
        return [Rows(G, h, False)]
    if kind == "sphere":
        G, h = rows([shape["R"], 0, 0, 0], np.vstack([np.zeros(3), eye]))
        return [Rows(G, h, True)]                 # ||y|| <= R alpha
    if kind == "cylinder":
        hl = shape["L"] / 2.0
        Go, ho = rows([hl, hl], np.array([[-1.0, 0, 0], [1.0, 0, 0]]))
        Gs, hs = rows([shape["R"], 0, 0], np.array([[0.0, 0, 0], [0, 1, 0],
                                                    [0, 0, 1]]))
        return [Rows(Go, ho, False), Rows(Gs, hs, True)]
    if kind == "capsule":
        hl = shape["L"] / 2.0
        # |lam| <= alpha L/2 and ||y - lam e1|| <= R alpha
        Go, ho = rows([hl, hl], np.zeros((2, 3)), [[-1.0], [1.0]])
        Gs, hs = rows([shape["R"], 0, 0, 0], np.vstack([np.zeros(3), eye]),
                      [[0.0], [-1.0], [0.0], [0.0]])
        return [Rows(Go, ho, False), Rows(Gs, hs, True)]
    if kind == "cone":
        # axis along body x: apex at y1 = -3H/4 alpha, base y1 = H/4 alpha
        tb, H = np.tan(shape["beta"]), shape["H"]
        Go, ho = rows([H / 4.0], np.array([[-1.0, 0, 0]]))
        Gs, hs = rows([tb * 3.0 * H / 4.0, 0, 0],
                      np.array([[tb, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]))
        return [Rows(Go, ho, False), Rows(Gs, hs, True)]
    if kind == "polygon":
        # a planar polygon A w <= alpha b in the body xy plane, swept by a
        # ball of radius R alpha: ||y - [w; 0]|| <= R alpha
        A, b = np.asarray(shape["A"]), np.asarray(shape["b"])
        Go, ho = rows(b, np.zeros((len(b), 3)), -A)
        Gs, hs = rows([shape["R"], 0, 0, 0], np.vstack([np.zeros(3), eye]),
                      [[0.0, 0.0], [-1.0, 0.0], [0.0, -1.0], [0.0, 0.0]])
        return [Rows(Go, ho, False), Rows(Gs, hs, True)]
    raise ValueError(f"unknown shape kind {kind!r}")


N_EXTRA = {"polytope": 0, "sphere": 0, "cylinder": 0, "capsule": 1,
           "cone": 0, "polygon": 2}


def pair_problem(robot: dict, obstacle: dict, r1, Q1, r2, Q2,
                 ar: Arith = REF):
    """(c, G, h, n_orth, soc_dims) of one robot-obstacle pair over a batch
    of poses: orthant rows first, then the second-order-cone blocks."""
    e1, e2 = N_EXTRA[robot["kind"]], N_EXTRA[obstacle["kind"]]
    n = 4 + e1 + e2
    blocks = (shape_rows(robot, r1, Q1, n, 4, ar)
              + shape_rows(obstacle, r2, Q2, n, 4 + e1, ar))
    orth = [b for b in blocks if not b.soc]
    soc = [b for b in blocks if b.soc]
    G = torch.cat([b.G for b in orth + soc], dim=1)
    h = torch.cat([b.h for b in orth + soc], dim=1)
    c = torch.zeros(n, dtype=ar.dtype, device=G.device)
    c[3] = 1.0
    return (c, G, h, sum(b.G.shape[1] for b in orth),
            tuple(b.G.shape[1] for b in soc))


# ---------------------------------------------------------------------------
# Interior-point method
# ---------------------------------------------------------------------------

class Cone:
    """K = R^l_+ x SOC(q_1) x ... with helpers over (B, m) vectors."""

    def __init__(self, n_orth: int, socs: Sequence[int]):
        self.l = n_orth
        self.socs = tuple(socs)
        self.m = n_orth + sum(socs)
        self.degree = n_orth + len(socs)
        self.offs = []
        o = n_orth
        for q in self.socs:
            self.offs.append((o, q))
            o += q

    def e(self, like):
        e = torch.zeros(like.shape[-1], dtype=like.dtype, device=like.device)
        e[:self.l] = 1.0
        for o, _ in self.offs:
            e[o] = 1.0
        return e

    def prod(self, u, v):
        """Jordan product u o v."""
        out = [u[:, :self.l] * v[:, :self.l]]
        for o, q in self.offs:
            a, b = u[:, o:o + q], v[:, o:o + q]
            out.append(torch.cat([(a * b).sum(-1, keepdim=True),
                                  a[:, :1] * b[:, 1:] + b[:, :1] * a[:, 1:]],
                                 dim=1))
        return torch.cat(out, dim=1)

    def div(self, lam, r):
        """x with lam o x = r."""
        out = [r[:, :self.l] / lam[:, :self.l]]
        for o, q in self.offs:
            l, v = lam[:, o:o + q], r[:, o:o + q]
            det = l[:, 0] ** 2 - (l[:, 1:] ** 2).sum(-1)
            x0 = (l[:, 0] * v[:, 0] - (l[:, 1:] * v[:, 1:]).sum(-1)) / det
            x1 = (v[:, 1:] - x0[:, None] * l[:, 1:]) / l[:, :1]
            out.append(torch.cat([x0[:, None], x1], dim=1))
        return torch.cat(out, dim=1)

    def shift_in(self, s):
        """s moved into the interior along e if it is not strictly inside
        (the usual least-squares start)."""
        worst = []
        if self.l:
            worst.append((-s[:, :self.l]).amax(-1))
        for o, q in self.offs:
            worst.append(torch.linalg.vector_norm(s[:, o + 1:o + q], dim=-1)
                         - s[:, o])
        a = torch.stack(worst, -1).amax(-1)
        return torch.where((a >= 0)[:, None], s + (1.0 + a)[:, None] * self.e(s),
                           s)

    def max_step(self, s, d):
        """Largest t with s + t d in the cone (inf where unbounded)."""
        inf = torch.full_like(s[:, 0], float("inf"))
        t = inf
        if self.l:
            ratio = torch.where(d[:, :self.l] < 0, -s[:, :self.l] / d[:, :self.l],
                                torch.full_like(d[:, :self.l], float("inf")))
            t = torch.minimum(t, ratio.amin(-1))
        for o, q in self.offs:
            a0, a1 = s[:, o], s[:, o + 1:o + q]
            d0, d1 = d[:, o], d[:, o + 1:o + q]
            A = d0 * d0 - (d1 * d1).sum(-1)
            Bq = 2.0 * (a0 * d0 - (a1 * d1).sum(-1))
            C = a0 * a0 - (a1 * a1).sum(-1)
            disc = Bq * Bq - 4.0 * A * C
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            qq = -0.5 * (Bq + torch.where(Bq >= 0, sq, -sq))
            r1 = torch.where(A != 0, qq / A, inf)
            r2 = torch.where(qq != 0, C / qq, inf)
            roots = torch.stack([r1, r2], -1)
            roots = torch.where((roots > 0) & (disc >= 0)[:, None], roots,
                                inf[:, None])
            tq = roots.amin(-1)
            # leaving through the apex side: s0 + t d0 must stay positive
            tq = torch.minimum(tq, torch.where(d0 < 0, -a0 / d0, inf))
            t = torch.minimum(t, tq)
        return t

    def nt_scaling(self, s, z):
        """Dense symmetric W (B, m, m) with W z = W^-1 s, and W^-1."""
        B, m = s.shape
        W = torch.zeros((B, m, m), dtype=s.dtype, device=s.device)
        Wi = torch.zeros_like(W)
        idx = torch.arange(self.l, device=s.device)
        w = torch.sqrt(s[:, :self.l] / z[:, :self.l])
        W[:, idx, idx] = w
        Wi[:, idx, idx] = 1.0 / w
        for o, q in self.offs:
            sv, zv = s[:, o:o + q], z[:, o:o + q]
            J = torch.diag(torch.tensor([1.0] + [-1.0] * (q - 1),
                                        dtype=s.dtype, device=s.device))
            sn = torch.sqrt(sv[:, 0] ** 2 - (sv[:, 1:] ** 2).sum(-1))
            zn = torch.sqrt(zv[:, 0] ** 2 - (zv[:, 1:] ** 2).sum(-1))
            sb, zb = sv / sn[:, None], zv / zn[:, None]
            gam = torch.sqrt((1.0 + (sb * zb).sum(-1)) / 2.0)
            # wb is the scaling point: (2 wb wb' - J) zb = sb; W is its
            # square root, the hyperbolic reflection through v
            wb = (sb + zb @ J) / (2.0 * gam[:, None])
            v = wb.clone()
            v[:, 0] += 1.0
            v = v / torch.sqrt(2.0 * (wb[:, 0] + 1.0))[:, None]
            eta = torch.sqrt(sn / zn)
            Wb = eta[:, None, None] * (2.0 * v[:, :, None] * v[:, None, :] - J)
            Jv = v @ J
            Wib = (2.0 * Jv[:, :, None] * Jv[:, None, :] - J) / eta[:, None, None]
            W[:, o:o + q, o:o + q] = Wb
            Wi[:, o:o + q, o:o + q] = Wib
        return W, Wi


def solve(c, G, h, cone: Cone, ar: Arith = REF, iters: int = 50,
          tol: float = 1e-10):
    """Batched  min c'z  s.t.  G z + s = h,  s in K.  Returns (z, s, y)
    with y the dual: of each problem the iterate with the least duality gap
    plus residual seen, which stops moving once both are below ``tol``
    (relative to the data's scale)."""
    c, G, h = ar.round(c), ar.round(G), ar.round(h)
    B, m, n = G.shape
    Gt = G.transpose(-1, -2)
    GtG = ar.mm(Gt, G)
    z = torch.linalg.solve_ex(GtG, ar.mv(Gt, h))[0]
    s = cone.shift_in(h - ar.mv(G, z))
    y = cone.shift_in(ar.mv(G, torch.linalg.solve_ex(GtG, -c.expand(B, n))[0]))
    scale = 1.0 + h.abs().amax(-1)
    inf = torch.full_like(scale, float("inf"))
    best, best_err = (z, s, y), inf
    for _ in range(iters):
        rx = ar.mv(Gt, y) + c
        rz = ar.mv(G, z) + s - h
        gap = (s * y).sum(-1)
        err = (gap.abs() + rz.abs().amax(-1) + rx.abs().amax(-1)) / scale
        err = torch.where(torch.isfinite(err), err, inf)
        better = err < best_err
        best = tuple(torch.where(better[:, None], a, b)
                     for a, b in zip((z, s, y), best))
        best_err = torch.where(better, err, best_err)
        if bool((best_err < tol).all()):
            break
        mu = gap / cone.degree
        W, Wi = cone.nt_scaling(s, y)
        lam = ar.mv(W, y)
        W2i = ar.mm(Wi, Wi)
        H = ar.mm(Gt, ar.mm(W2i, G))

        def newton(rc):
            Wq = ar.mv(W, cone.div(lam, rc))
            dz = torch.linalg.solve_ex(
                H, -rx - ar.mv(Gt, ar.mv(W2i, Wq + rz)))[0]
            dy = ar.mv(W2i, ar.mv(G, dz) + Wq + rz)
            return dz, -rz - ar.mv(G, dz), dy

        _, ds_a, dy_a = newton(-cone.prod(lam, lam))
        ta = torch.clamp(torch.minimum(cone.max_step(s, ds_a),
                                       cone.max_step(y, dy_a)), max=1.0)
        sig = (((s + ta[:, None] * ds_a) * (y + ta[:, None] * dy_a)).sum(-1)
               / gap).clamp(0.0, 1.0) ** 3
        corr = cone.prod(ar.mv(Wi, ds_a), ar.mv(W, dy_a))
        dz, ds, dy = newton(-cone.prod(lam, lam) - corr
                            + (sig * mu)[:, None] * cone.e(s))
        t = 0.99 * torch.minimum(cone.max_step(s, ds), cone.max_step(y, dy))
        t = torch.clamp(t, max=1.0)
        t = torch.where(torch.isfinite(t) & (best_err >= tol), t,
                        torch.zeros_like(t))[:, None]
        z, s, y = z + t * dz, s + t * ds, y + t * dy
    return best


def alphas(robot: dict, obstacles: Sequence[dict], r_robot, Q_robot,
           obs_r, obs_Q, ar: Arith = REF, block: int = 65536) -> torch.Tensor:
    """alpha (B, n_obs) of a robot at poses (r_robot (B, 3), Q_robot
    (B, 3, 3)) against each obstacle at its pose (obs_r (n_obs, 3), obs_Q
    (n_obs, 3, 3)), in blocks of ``block`` problems."""
    B = r_robot.shape[0]
    out = torch.empty((B, len(obstacles)), dtype=ar.dtype,
                      device=r_robot.device)
    for j, ob in enumerate(obstacles):
        for lo in range(0, B, block):
            hi = min(B, lo + block)
            r1, Q1 = r_robot[lo:hi], Q_robot[lo:hi]
            r2 = obs_r[j].expand(hi - lo, 3)
            Q2 = obs_Q[j].expand(hi - lo, 3, 3)
            c, G, h, nl, socs = pair_problem(robot, ob, r1, Q1, r2, Q2, ar)
            z, _, _ = solve(c, G, h, Cone(nl, socs), ar)
            out[lo:hi, j] = z[:, 3]
    return out
