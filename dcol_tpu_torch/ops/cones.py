"""Batched cone algebra for the composite cone  K = R^n_+ x SOC(s1) x SOC(s2).

Port of ``dcol_tpu/ops/cones.py``: the layout is static (``ConeLayout``),
every op broadcasts over leading batch dims (the last axis is the cone
axis), and the SOC Nesterov-Todd scaling uses the closed form
``Wbar^{-1} = J Wbar J`` (no factorisation of the scaling matrix).
"""

from __future__ import annotations

import dataclasses

import torch

_TINY = 1e-25


@dataclasses.dataclass(frozen=True)
class ConeLayout:
    """Static row layout: [orthant (n_ort) | SOC1 (s1) | SOC2 (s2)]."""

    n_ort: int
    s1: int = 4
    s2: int = 4

    @property
    def nr(self) -> int:
        return self.n_ort + self.s1 + self.s2

    @property
    def degree(self) -> int:
        # barrier degree: 1 per orthant row + 1 per SOC block
        return self.n_ort + (self.s1 > 0) + (self.s2 > 0)

    def split(self, v):
        n = self.n_ort
        return v[..., :n], v[..., n:n + self.s1], v[..., n + self.s1:]

    def join(self, o, a, b):
        return torch.cat([o, a, b], dim=-1)


# ---------------------------------------------------------------------------
# SOC primitives (last axis = cone axis)
# ---------------------------------------------------------------------------

def soc_quad(x):
    """x0^2 - |x1|^2, shape (...,)."""
    return x[..., 0] ** 2 - torch.sum(x[..., 1:] ** 2, dim=-1)


def soc_product(u, v):
    """Jordan product of two SOC vectors: [u.v ; u0 v1 + v0 u1]."""
    if u.shape[-1] == 0:
        return u
    head = torch.sum(u * v, dim=-1, keepdim=True)
    tail = u[..., :1] * v[..., 1:] + v[..., :1] * u[..., 1:]
    return torch.cat([head, tail], dim=-1)


def soc_inv_product(u, w):
    """v with u o v = w (inverse Jordan product)."""
    if u.shape[-1] == 0:
        return u
    u0, u1 = u[..., :1], u[..., 1:]
    w0, w1 = w[..., :1], w[..., 1:]
    rho = soc_quad(u)[..., None]
    nu = torch.sum(u1 * w1, dim=-1, keepdim=True)
    head = u0 * w0 - nu
    tail = (nu / u0 - w0) * u1 + (rho / u0) * w1
    return torch.cat([head, tail], dim=-1) / rho


def cone_product(lay: ConeLayout, u, v):
    uo, u1, u2 = lay.split(u)
    vo, v1, v2 = lay.split(v)
    return lay.join(uo * vo, soc_product(u1, v1), soc_product(u2, v2))


def inverse_cone_product(lay: ConeLayout, lam, v):
    lo, l1, l2 = lay.split(lam)
    vo, v1, v2 = lay.split(v)
    return lay.join(vo / lo, soc_inv_product(l1, v1), soc_inv_product(l2, v2))


def gen_e(lay: ConeLayout, dtype, device=None):
    """Identity element of the cone: ones on the orthant, e1 per SOC."""
    e = [1.0] * lay.n_ort
    if lay.s1:
        e += [1.0] + [0.0] * (lay.s1 - 1)
    if lay.s2:
        e += [1.0] + [0.0] * (lay.s2 - 1)
    return torch.tensor(e, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Line search (largest step keeping the iterate in the cone interior)
# ---------------------------------------------------------------------------

def _ort_linesearch(x, dx):
    neg = dx < 0
    ratios = torch.where(neg, -x / torch.where(neg, dx, -torch.ones_like(dx)),
                         torch.full_like(dx, float("inf")))
    return torch.clamp(torch.amin(ratios, dim=-1), max=1.0)


def _soc_linesearch(y, d):
    if y.shape[-1] == 0:
        return torch.ones(y.shape[:-1], dtype=y.dtype, device=y.device)
    y0, yv = y[..., 0], y[..., 1:]
    d0, dv = d[..., 0], d[..., 1:]
    nu = torch.clamp(soc_quad(y), min=_TINY)
    sq = torch.sqrt(nu)
    zeta = y0 * d0 - torch.sum(yv * dv, dim=-1)
    rho0 = zeta / nu
    coef = (zeta / sq + d0) / (y0 / sq + 1.0)
    rho_v = dv / sq[..., None] - coef[..., None] * yv / nu[..., None]
    rnorm = torch.linalg.vector_norm(rho_v, dim=-1)
    lim = 1.0 / torch.clamp(rnorm - rho0, min=_TINY)
    return torch.where(rnorm > rho0, torch.clamp(lim, max=1.0),
                       torch.ones_like(lim))


def linesearch(lay: ConeLayout, x, dx):
    """max alpha in [0, 1] with x + alpha dx in the cone."""
    xo, x1, x2 = lay.split(x)
    do, d1, d2 = lay.split(dx)
    if lay.n_ort:
        a = _ort_linesearch(xo, do)
    else:
        a = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    a = torch.minimum(a, _soc_linesearch(x1, d1))
    return torch.minimum(a, _soc_linesearch(x2, d2))


# ---------------------------------------------------------------------------
# Feasibility shift
# ---------------------------------------------------------------------------

def bring2cone(lay: ConeLayout, r):
    """Shift r along the cone identity until strictly feasible."""
    ro, r1, r2 = lay.split(r)
    a = torch.full(r.shape[:-1], float("-inf"), dtype=r.dtype,
                   device=r.device)
    if lay.n_ort:
        a = torch.maximum(a, -torch.amin(ro, dim=-1))
    if lay.s1:
        a = torch.maximum(a, -(r1[..., 0] - torch.linalg.vector_norm(
            r1[..., 1:], dim=-1)))
    if lay.s2:
        a = torch.maximum(a, -(r2[..., 0] - torch.linalg.vector_norm(
            r2[..., 1:], dim=-1)))
    shift = (1.0 + a)[..., None] * gen_e(lay, r.dtype, r.device)
    return torch.where((a < 0)[..., None], r, r + shift)


# ---------------------------------------------------------------------------
# Nesterov-Todd scaling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NTScaling:
    """w_ort: (..., n_ort); per SOC: eta (...,) and wbar (..., s) with
    wbar' J wbar = 1."""

    w_ort: torch.Tensor
    eta1: torch.Tensor
    wbar1: torch.Tensor
    eta2: torch.Tensor
    wbar2: torch.Tensor


def _soc_nt(s, z):
    """(eta, wbar) for one SOC block."""
    if s.shape[-1] == 0:
        return torch.ones(s.shape[:-1], dtype=s.dtype, device=s.device), s
    js = torch.clamp(soc_quad(s), min=_TINY)
    jz = torch.clamp(soc_quad(z), min=_TINY)
    sbar = s / torch.sqrt(js)[..., None]
    zbar = z / torch.sqrt(jz)[..., None]
    gamma = torch.sqrt((1.0 + torch.sum(sbar * zbar, dim=-1)) / 2.0)
    Jz = torch.cat([zbar[..., :1], -zbar[..., 1:]], dim=-1)
    wbar = (sbar + Jz) / (2.0 * gamma[..., None])
    eta = (js / jz) ** 0.25
    return eta, wbar


def nt_scalings(lay: ConeLayout, s, z) -> NTScaling:
    so, s1, s2 = lay.split(s)
    zo, z1, z2 = lay.split(z)
    eta1, wbar1 = _soc_nt(s1, z1)
    eta2, wbar2 = _soc_nt(s2, z2)
    return NTScaling(torch.sqrt(so / zo), eta1, wbar1, eta2, wbar2)


def _soc_apply(eta, wbar, v, inverse: bool):
    """eta*Wbar v (or its inverse) with
    Wbar = [[w0, w1'], [w1, I + w1 w1'/(1+w0)]];  Wbar^{-1} = J Wbar J."""
    if v.shape[-1] == 0:
        return v
    w0, w1 = wbar[..., :1], wbar[..., 1:]
    sgn = -1.0 if inverse else 1.0
    v0, v1 = v[..., :1], v[..., 1:]
    w1v1 = torch.sum(w1 * v1, dim=-1, keepdim=True)
    head = w0 * v0 + sgn * w1v1
    tail = v1 + (sgn * v0 + w1v1 / (1.0 + w0)) * w1
    out = torch.cat([head, tail], dim=-1)
    scale = eta[..., None]
    return out / scale if inverse else out * scale


def _soc_apply_mat(eta, wbar, M, inverse: bool):
    """Apply the SOC scaling along the rows axis (-2) of a matrix block."""
    out = _soc_apply(eta[..., None], wbar[..., None, :], M.transpose(-1, -2),
                     inverse)
    return out.transpose(-1, -2)


def nt_apply(lay: ConeLayout, W: NTScaling, v):
    """W v."""
    vo, v1, v2 = lay.split(v)
    return lay.join(W.w_ort * vo,
                    _soc_apply(W.eta1, W.wbar1, v1, inverse=False),
                    _soc_apply(W.eta2, W.wbar2, v2, inverse=False))


def nt_solve(lay: ConeLayout, W: NTScaling, v):
    """W^{-1} v."""
    vo, v1, v2 = lay.split(v)
    return lay.join(vo / W.w_ort,
                    _soc_apply(W.eta1, W.wbar1, v1, inverse=True),
                    _soc_apply(W.eta2, W.wbar2, v2, inverse=True))


def nt_solve_mat(lay: ConeLayout, W: NTScaling, G):
    """W^{-1} G on the rows axis (-2)."""
    n = lay.n_ort
    Go = G[..., :n, :] / W.w_ort[..., None]
    G1 = _soc_apply_mat(W.eta1, W.wbar1, G[..., n:n + lay.s1, :], inverse=True)
    G2 = _soc_apply_mat(W.eta2, W.wbar2, G[..., n + lay.s1:, :], inverse=True)
    return torch.cat([Go, G1, G2], dim=-2)
