"""Scenario-parallel batching: many perturbed trajectory-optimisation
problems solved at once along the solver's scenario dim S.  Port of
``dcol_tpu/parallel/batch.py``.

Scenario noise comes from numpy's ``default_rng(seed)``, drawn in the same
order as the JAX package, so both packages solve the same scenarios."""

from __future__ import annotations

import numpy as np
import torch

from dcol_tpu_torch.parallel.mesh import summarize  # noqa: F401 (re-export)
from dcol_tpu_torch.solver import altro


def perturb_scenarios(params, X0, U0, *, n: int, seed: int = 0,
                      x0_sigma: float = 0.05, obs_sigma: float = 0.0):
    """Batch of scenarios: perturbed initial state (and optionally obstacle
    positions).  Returns (params_b, X0_b, U0_b) with leading dim n."""
    rng = np.random.default_rng(seed)
    dt, dev = X0.dtype, X0.device
    X0_b = X0[None].repeat(n, 1, 1)
    X0_b[:, 0, :] += torch.as_tensor(rng.normal(0.0, x0_sigma, (n, X0.shape[1])),
                                     dtype=dt, device=dev)
    U0_b = U0[None].repeat(n, 1, 1)
    params_b = {k: v[None].repeat((n,) + (1,) * v.dim())
                for k, v in params.items()}
    if obs_sigma:
        params_b["obs_r"] = params_b["obs_r"] + torch.as_tensor(
            rng.normal(0.0, obs_sigma, tuple(params_b["obs_r"].shape)),
            dtype=dt, device=dev)
    return params_b, X0_b, U0_b


def solve_batch(sys, params_b, cfg: altro.AltroConfig, X0_b, U0_b):
    """Full solves of a scenario batch (leading dim of every input)."""
    return altro.solve(sys, params_b, cfg, X0_b, U0_b)


def solve_single(sys, params, cfg: altro.AltroConfig, X0, U0):
    """One solve: a batch of one scenario, returned without the batch dim.

    The JAX package replicates the problem (``replicas=8``) because XLA
    picks slow layouts for a batch of one on the TPU; eager PyTorch has no
    such layouts, so the port solves the one scenario alone."""
    params_b = {k: v[None] for k, v in params.items()}
    st = altro.solve(sys, params_b, cfg, X0[None], U0[None])
    return altro.tree_map(lambda a: a[0], st)


def solve_batch_blocked(sys, params_b, cfg: altro.AltroConfig, X0_b, U0_b,
                        *, block: int = 128):
    """Block-sequential batched solves: blocks of ``block`` scenarios, one
    :func:`solve_batch` each, concatenated in order.

    The lock-step loop runs until its slowest scenario stops, so every
    scenario of a batch pays for the stragglers' iterations; blocks bound
    that to one block and keep each launch at the block's width.  Per
    scenario this is the algorithm of :func:`solve_batch`; bitwise equality
    is not promised, since a reduction may run in another order at another
    batch size.  ``block`` must divide the batch (``ValueError``
    otherwise)."""
    n = X0_b.shape[0]
    if n % block:
        raise ValueError(f"batch {n} not divisible by block {block}")
    if n == block:
        return solve_batch(sys, params_b, cfg, X0_b, U0_b)
    outs = [solve_batch(sys, {k: v[lo:lo + block] for k, v in params_b.items()},
                        cfg, X0_b[lo:lo + block], U0_b[lo:lo + block])
            for lo in range(0, n, block)]
    return altro.tree_map(lambda *a: torch.cat(a), *outs)
