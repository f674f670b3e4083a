"""Scenario-parallel batching: many perturbed trajectory-optimisation
problems solved at once along the solver's scenario dim S.  Port of
``dcol_tpu/parallel/batch.py`` (plus ``summarize`` from
``dcol_tpu/parallel/mesh.py``).

Scenario noise comes from numpy's ``default_rng(seed)``, drawn in the same
order as the JAX package, so both packages solve the same scenarios."""

from __future__ import annotations

import numpy as np
import torch

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
    """One solve: a batch of one scenario, returned without the batch
    dim."""
    params_b = {k: v[None] for k, v in params.items()}
    st = altro.solve(sys, params_b, cfg, X0[None], U0[None])
    return _index(st, 0)


def _index(tree, i):
    if isinstance(tree, tuple):
        out = [_index(a, i) for a in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree[i]


def summarize(batched_state) -> dict:
    """Aggregate metrics of a solved batch."""
    st = batched_state
    return {
        "n": int(st.converged.shape[0]),
        "n_converged": int(st.converged.sum()),
        "n_failed": int(st.failed.sum()),
        "mean_iters": float(st.iter.double().mean()),
        "max_convio": float(st.convio.max()),
    }
