"""Conversions from the JAX package's data (as numpy arrays) to the port's
tensors, so both packages can compute from the same inputs."""

from __future__ import annotations

import numpy as np
import torch

PARAM_KEYS = ("Q", "R", "Qf", "Xref", "Uref", "u_min", "u_max", "obs_r",
              "obs_p")


def params_from_numpy(params_np, *, device, dtype):
    """The JAX package's ``params`` dict (numpy arrays, any leading scenario
    dim kept as is) -> dict of tensors."""
    missing = [k for k in PARAM_KEYS if k not in params_np]
    if missing:
        raise KeyError(f"params missing {missing}")
    return {k: torch.tensor(np.array(params_np[k]), dtype=dtype,
                               device=device) for k in PARAM_KEYS}


def warm_from_numpy(warm_np, *, device, dtype):
    """A warm (x, s, z) triple, or a tuple of them (one per obstacle group),
    of numpy arrays -> the same structure of tensors."""
    if len(warm_np) == 3 and not isinstance(warm_np[0], (tuple, list)):
        return tuple(torch.tensor(np.array(a), dtype=dtype,
                                     device=device) for a in warm_np)
    return tuple(warm_from_numpy(g, device=device, dtype=dtype)
                 for g in warm_np)


def carry_from_numpy(carry_np, *, device, dtype):
    """The JAX package's ``MpcCarry`` (x, U, mu, mux, lambd, rho) as numpy
    arrays, for one scenario (x (nx,)) or a vmapped batch (x (S, nx)) ->
    the port's ``MpcCarry`` with a leading scenario dim S."""
    from dcol_tpu_torch.solver.mpc import MpcCarry

    x, U, mu, mux, lambd, rho = (np.asarray(a) for a in carry_np)
    if x.ndim == 1:
        x, U, mu, mux, lambd, rho = (a[None] for a in
                                     (x, U, mu, mux, lambd, rho))
    T = lambda a: torch.tensor(np.array(a), dtype=dtype, device=device)
    return MpcCarry(T(x), T(U), T(mu), T(mux), T(lambd),
                    T(rho).reshape(x.shape[0]))
