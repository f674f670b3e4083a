"""Differentiable proximity (DCOL alpha) between two posed convex primitives.

Port of ``dcol_tpu/ops/proximity.py``.  ``alpha`` is the minimum uniform
scaling of both primitives at which they touch; ``alpha < 1`` means
collision.  The value is one conic LP per pair, solved on the tensors'
device: the hand-written CUDA kernel (:mod:`dcol_tpu_torch.ops.pdip_cuda`,
one specialisation per exact pair layout) for CUDA tensors, its plain
PyTorch version (:mod:`dcol_tpu_torch.ops.pdip`) for CPU tensors.

The gradient is the envelope theorem,

    d alpha / d theta = d/d theta [ z*' (G(theta) x* - h(theta)) ]

with the optimal primal/dual pair (x*, z*) held fixed: one reverse-mode pass
through the closed-form assembly.  Padding rows have zero dual weight and
constant G, h, so they drop out.

Poses carry any leading batch dims (all four broadcast together) where the
JAX package ``vmap``s.  :func:`proximity_alpha` is alpha as a
:class:`torch.autograd.Function`, so ``.backward()`` goes through collision
constraints (the JAX package's ``custom_vjp``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from dcol_tpu_torch.geometry import assembly
from dcol_tpu_torch.geometry.primitives import Shape
from dcol_tpu_torch.ops.cones import ConeLayout
from dcol_tpu_torch.ops.pdip import solve_socp
from dcol_tpu_torch.ops.pdip_cuda import solve_socp_cuda


class ProximityResult(NamedTuple):
    alpha: torch.Tensor      # (...,) scaling to contact; < 1 means collision
    contact: torch.Tensor    # (..., 3) contact point
    x: torch.Tensor          # (..., nv) primal solution
    z: torch.Tensor          # (..., nr) dual solution
    converged: torch.Tensor  # (...,) bool
    iters: torch.Tensor      # (...,) int32


def pair_layouts(s1: Shape, s2: Shape):
    """(PairLayout, ConeLayout) for a standalone pair: the EXACT minimal
    layout (no padding rows; absent SOC blocks dropped)."""
    pl = assembly.exact_layout(s1, s2)
    return pl, ConeLayout(pl.n_ort, pl.s1, pl.s2)


def _poses(r1, p1, r2, p2):
    poses = [torch.as_tensor(a) for a in (r1, p1, r2, p2)]
    dt = poses[0].dtype if poses[0].is_floating_point() else torch.float64
    dev = poses[0].device
    return [a.to(dtype=dt, device=dev) for a in poses]


def proximity(s1: Shape, s2: Shape, r1, p1, r2, p2, *, layouts=None,
              tol: float = 1e-6, max_iters: int = 30,
              jitter: float = 0.0) -> ProximityResult:
    """Proximity between two posed primitives; poses (..., 3) broadcast
    together over their leading dims."""
    pl, cl = layouts if layouts is not None else pair_layouts(s1, s2)
    r1, p1, r2, p2 = _poses(r1, p1, r2, p2)
    c, G, h = assembly.assemble_pair(s1, s2, pl, r1, p1, r2, p2)
    batch = G.shape[:-2]
    B = 1
    for n in batch:
        B *= n
    c, G, h = (a.reshape((B,) + a.shape[len(batch):]) for a in (c, G, h))
    solver = solve_socp_cuda if G.is_cuda else solve_socp
    sol = solver(c.contiguous(), G.contiguous(), h.contiguous(), cl, tol=tol,
                 max_iters=max_iters, jitter=jitter)
    x = sol.x.reshape(batch + sol.x.shape[-1:])
    z = sol.z.reshape(batch + sol.z.shape[-1:])
    return ProximityResult(x[..., 3], x[..., :3], x, z,
                           sol.converged.reshape(batch),
                           sol.iters.reshape(batch))


def _envelope_vjp(s1: Shape, s2: Shape, pl, x, z, poses: Sequence,
                  ct, argnums):
    """Cotangent ``ct`` (alpha's shape) pulled back to the poses in
    ``argnums`` through the Lagrangian z'(G x - h), with (x, z) fixed."""
    x, z = x.detach(), z.detach()
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(i in argnums)
                  for i, p in enumerate(poses)]
        _, G, h = assembly.assemble_pair(s1, s2, pl, *leaves)
        Gx = torch.sum(G * x[..., None, :], dim=-1)
        lag = torch.sum(z * (Gx - h), dim=-1)
        wrt = [leaves[i] for i in argnums]
        grads = torch.autograd.grad(lag, wrt, grad_outputs=ct.expand_as(lag),
                                    allow_unused=True)
    # a pose the pair's constraints do not depend on (a sphere's attitude)
    return tuple(torch.zeros_like(w) if g is None else g
                 for w, g in zip(wrt, grads))


def envelope_gradient(s1: Shape, s2: Shape, pl, x, z, r1, p1, r2, p2,
                      argnums=(0, 1, 2, 3)):
    """d alpha / d(poses) with (x, z) fixed at the optimum: a tuple of
    gradients matching ``argnums`` over (r1, p1, r2, p2), each of its
    pose's shape (a pose shared by a batch gets the batch's sum)."""
    poses = _poses(r1, p1, r2, p2)
    ones = torch.ones((), dtype=x.dtype, device=x.device)
    return _envelope_vjp(s1, s2, pl, x, z, poses, ones, tuple(argnums))


def proximity_with_grad(s1: Shape, s2: Shape, r1, p1, r2, p2, *,
                        layouts=None, argnums=(0, 1), tol: float = 1e-6,
                        max_iters: int = 30, jitter: float = 0.0):
    """One solve returning alpha and its pose gradients."""
    pl, cl = layouts if layouts is not None else pair_layouts(s1, s2)
    res = proximity(s1, s2, r1, p1, r2, p2, layouts=(pl, cl), tol=tol,
                    max_iters=max_iters, jitter=jitter)
    grads = envelope_gradient(s1, s2, pl, res.x, res.z, r1, p1, r2, p2,
                              argnums=argnums)
    return res, grads


class _ProximityAlpha(torch.autograd.Function):
    """alpha with the envelope-theorem backward: the forward solves on the
    tensors' device (kernel on CUDA, plain version on CPU), the backward
    pulls the cotangent back through the assembly with (x, z) detached."""

    @staticmethod
    def forward(ctx, s1, s2, opts, r1, p1, r2, p2):
        layouts, tol, max_iters, jitter = opts
        res = proximity(s1, s2, r1, p1, r2, p2, layouts=layouts, tol=tol,
                        max_iters=max_iters, jitter=jitter)
        ctx.meta = (s1, s2, layouts[0])
        ctx.save_for_backward(res.x, res.z, r1, p1, r2, p2)
        return res.alpha

    @staticmethod
    def backward(ctx, ct):
        s1, s2, pl = ctx.meta
        x, z, *poses = ctx.saved_tensors
        want = tuple(i for i in range(4) if ctx.needs_input_grad[3 + i])
        grads = _envelope_vjp(s1, s2, pl, x, z, poses, ct, want)
        out = [None] * 4
        for i, g in zip(want, grads):
            out[i] = g
        return (None, None, None, *out)


def proximity_alpha(s1: Shape, s2: Shape, r1, p1, r2, p2, *, layouts=None,
                    tol: float = 1e-6, max_iters: int = 30,
                    jitter: float = 0.0):
    """alpha(s1 at (r1, p1), s2 at (r2, p2)), differentiable with respect to
    all four poses through the envelope theorem."""
    if layouts is None:
        layouts = pair_layouts(s1, s2)
    r1, p1, r2, p2 = _poses(r1, p1, r2, p2)
    return _ProximityAlpha.apply(s1, s2, (layouts, tol, max_iters, jitter),
                                 r1, p1, r2, p2)
