"""Batched primal-dual interior-point solver for small conic LPs

    min  c'x   s.t.  G x + s = h,   s in K = R^n_+ x SOC(s1) x SOC(s2)

with Nesterov-Todd scaling, a Mehrotra predictor-corrector and a
normal-equations Newton solve.  This is the plain PyTorch version of the
hand-written CUDA kernel (:mod:`dcol_tpu_torch.ops.pdip_cuda`): the CPU path
runs it, and the kernel is held against it on the card.  Port of
``dcol_tpu/ops/pdip.py::solve_socp``.

Per member, a problem is done once ``mu < tol`` or ``mu`` is not finite
(tested at the start of an iteration, before the step); a candidate step is
applied only if x, s and z all stay finite, otherwise the member freezes for
good.  Freezing is by selection, never by multiplying by zero.  ``iters``
counts the applied steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dcol_tpu_torch.ops import chol
from dcol_tpu_torch.ops.cones import (
    ConeLayout,
    bring2cone,
    cone_product,
    gen_e,
    inverse_cone_product,
    linesearch,
    nt_apply,
    nt_scalings,
    nt_solve,
    nt_solve_mat,
)


class SocpSolution(NamedTuple):
    x: torch.Tensor          # (..., nv)
    s: torch.Tensor          # (..., nr)
    z: torch.Tensor          # (..., nr)
    iters: torch.Tensor      # (...,) int32: steps applied
    converged: torch.Tensor  # (...,) bool: mu < tol on the final iterate


def _mu(lay: ConeLayout, s, z):
    return torch.sum(s * z, dim=-1) / lay.degree


def _mv(G, x):
    """G x: G (..., r, v), x (..., v) -> (..., r)."""
    return (G @ x[..., :, None])[..., 0]


def _rmv(G, z):
    """G' z: G (..., r, v), z (..., r) -> (..., v)."""
    return (z[..., None, :] @ G)[..., 0, :]


def initialize(lay: ConeLayout, c, G, h, jitter):
    """Least-squares primal/dual start shifted into the cone."""
    L = chol.chol_factor(G.transpose(-1, -2) @ G, jitter)
    x_hat = chol.chol_solve(L, _rmv(G, h))
    s_hat = bring2cone(lay, _mv(G, x_hat) - h)
    z_hat = bring2cone(lay, _mv(G, chol.chol_solve(L, -c)))
    return x_hat, s_hat, z_hat


def warm_initialize(lay: ConeLayout, x, s, z, margin: float = 1e-3):
    """Shift a previous optimum strictly back into the cone interior."""
    e = gen_e(lay, s.dtype, s.device)
    return x, bring2cone(lay, s + margin * e), bring2cone(lay, z + margin * e)


def check_args(c, G, h, lay: ConeLayout, warm, skip):
    """Shape checks shared by the plain version and the kernel's wrapper."""
    if G.dim() < 2 or G.shape[-2] != lay.nr:
        raise ValueError(f"G {tuple(G.shape)} does not match layout {lay}")
    nv = G.shape[-1]
    if c.shape != G.shape[:-2] + (nv,) or h.shape != G.shape[:-1]:
        raise ValueError(f"c {tuple(c.shape)}, G {tuple(G.shape)}, "
                         f"h {tuple(h.shape)} disagree")
    if skip is not None and warm is None:
        raise ValueError(
            "skip= requires warm=: a skipped member's output is its entry "
            "iterate, which is only meaningful as a previous converged "
            "solution, not the cold least-squares initializer")
    if warm is not None:
        x, s, z = warm
        if x.shape != c.shape or s.shape != h.shape or z.shape != h.shape:
            raise ValueError("warm (x, s, z) shapes disagree with (c, h)")


def solve_socp(c, G, h, lay: ConeLayout, *, tol: float = 1e-6,
               max_iters: int = 30, jitter: float = 0.0,
               warm=None, skip: Optional[torch.Tensor] = None,
               warm_margin: float = 1e-3) -> SocpSolution:
    """Solve a batch of conic LPs; leading dims of c/G/h are batch dims.

    ``warm``: optional (x, s, z) from a previous nearby solve.  ``skip``:
    optional bool (broadcastable to the batch) marking members whose result
    the caller discards: they start done and return the warm-initialised
    iterate with zero iterations.  Needs ``warm``."""
    check_args(c, G, h, lay, warm, skip)
    if warm is not None:
        x, s, z = warm_initialize(lay, *warm, margin=warm_margin)
    else:
        x, s, z = initialize(lay, c, G, h, jitter)
    e = gen_e(lay, G.dtype, G.device)
    batch_shape = G.shape[:-2]
    done = torch.zeros(batch_shape, dtype=torch.bool, device=G.device)
    if skip is not None:
        done = done | skip
    iters = torch.zeros(batch_shape, dtype=torch.int32, device=G.device)
    Gt = G.transpose(-1, -2)

    for _ in range(max_iters):
        if bool(done.all()):
            break
        W = nt_scalings(lay, s, z)
        lam = nt_apply(lay, W, z)
        lam_lam = cone_product(lay, lam, lam)
        rx = _rmv(G, z) + c
        rz = s + _mv(G, x) - h
        mu = _mu(lay, s, z)
        done = done | (mu < tol) | ~torch.isfinite(mu)

        G_tilde = nt_solve_mat(lay, W, G)
        L = chol.chol_factor(G_tilde.transpose(-1, -2) @ G_tilde, jitter)

        def newton(lam_ds):
            b_z = nt_solve(lay, W, -rz - nt_apply(lay, W, lam_ds))
            dx = chol.chol_solve(L, -rx + _rmv(G_tilde, b_z))
            dz = nt_solve(lay, W, _mv(G_tilde, dx) - b_z)
            ds = nt_apply(lay, W, lam_ds - nt_apply(lay, W, dz))
            return dx, ds, dz

        # affine (predictor) step
        dx_a, ds_a, dz_a = newton(inverse_cone_product(lay, lam, -lam_lam))
        a_aff = torch.minimum(linesearch(lay, s, ds_a),
                              linesearch(lay, z, dz_a))[..., None]
        rho = (torch.sum((s + a_aff * ds_a) * (z + a_aff * dz_a), dim=-1)
               / torch.sum(s * z, dim=-1))
        sigma = torch.clamp(rho, 0.0, 1.0) ** 3

        # centering + corrector step
        ds_rhs = (-lam_lam
                  - cone_product(lay, nt_solve(lay, W, ds_a),
                                 nt_apply(lay, W, dz_a))
                  + (sigma * mu)[..., None] * e)
        dx_c, ds_c, dz_c = newton(inverse_cone_product(lay, lam, ds_rhs))
        a = torch.clamp(0.99 * torch.minimum(linesearch(lay, s, ds_c),
                                             linesearch(lay, z, dz_c)),
                        max=1.0)[..., None]

        xn, sn, zn = x + a * dx_c, s + a * ds_c, z + a * dz_c
        good = (torch.isfinite(xn).all(-1) & torch.isfinite(sn).all(-1)
                & torch.isfinite(zn).all(-1))
        act = ~done & good
        x = torch.where(act[..., None], xn, x)
        s = torch.where(act[..., None], sn, s)
        z = torch.where(act[..., None], zn, z)
        done = done | ~good  # numerical breakdown: permanent freeze
        iters = iters + act.to(torch.int32)

    mu_f = _mu(lay, s, z)
    converged = torch.isfinite(mu_f) & (mu_f < tol)
    return SocpSolution(x, s, z, iters, converged)
