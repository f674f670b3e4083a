"""The one traffic generator: a configuration's problem and a mix's
scenario batches, made from the seed.

Copies of the port's draws, kept here so that the port cannot move them:
``perturb_scenarios`` (``dcol_tpu_torch/parallel/batch.py``) for a planning
batch, ``benchmarks/bench_mpc.py``'s initial states for the closed loop.
Batch k of a run draws from ``numpy.random.default_rng([seed, k])``."""

from __future__ import annotations

import numpy as np
import torch


def reference_path(config: dict, N: int) -> np.ndarray:
    """The tracked reference (N, nx) of the configuration at horizon N."""
    x0, xg = np.asarray(config["x0"], float), np.asarray(config["xg"], float)
    kind = config["xref"]
    if kind == "constant_goal":
        return np.tile(xg, (N, 1))
    if kind == "linear_interp":
        # positions and attitudes interpolated, constant velocity, zero
        # angular rate (the quadrotor's reference)
        t = np.arange(N)[:, None] / (N - 1)
        pos = x0[0:3] + t * (xg[0:3] - x0[0:3])
        att = x0[6:9] + t * (xg[6:9] - x0[6:9])
        vel = np.tile((xg[0:3] - x0[0:3]) / ((N - 1) * config["dt"]), (N, 1))
        return np.concatenate([pos, vel, att, np.zeros((N, 3))], axis=1)
    raise ValueError(f"unknown reference kind {kind!r}")


def problem(config: dict, N: int, device, dtype=torch.float32):
    """(params, X0, U0) of one scenario at horizon N, as the solver takes
    them: params without the scenario dim."""
    nx, nu = config["nx"], config["nu"]
    T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                  dtype=dtype, device=device)
    params = {
        "Q": T(np.diag(config["Q_diag"])),
        "R": T(np.diag(config["R_diag"])),
        "Qf": T(np.diag(config["Qf_diag"])),
        "Xref": T(reference_path(config, N)),
        "Uref": T(np.full((N - 1, nu), config["uref"])),
        "u_min": T(np.full((nu,), config["u_min"])),
        "u_max": T(np.full((nu,), config["u_max"])),
        "obs_r": T([o["r"] for o in config["obstacles"]]),
        "obs_p": T([o["p"] for o in config["obstacles"]]),
    }
    X0 = T(np.tile(np.asarray(config["x0"], float), (N, 1)))
    U0 = T(np.asarray(config["U0"], float)[:N - 1])
    if U0.shape != (N - 1, nu):
        raise ValueError(f"U0 has {U0.shape[0]} knots; horizon {N} needs "
                         f"{N - 1}")
    return params, X0, U0


def noise(seed: int, batch: int, n: int, nx: int, sigma: float) -> np.ndarray:
    """Initial-state noise (n, nx) of batch ``batch`` of a run."""
    return np.random.default_rng([seed, batch]).normal(0.0, sigma, (n, nx))


def scenarios(config: dict, mix: dict, seed: int, batch: int, device,
              dtype=torch.float32):
    """Batch ``batch`` of a mix: (params_b, X0_b, U0_b) with leading dim
    ``mix["scenarios"]``, each scenario's initial state perturbed."""
    N = mix.get("horizon", config["N"])
    params, X0, U0 = problem(config, N, device, dtype)
    n, nx = mix["scenarios"], config["nx"]
    X0_b = X0[None].repeat(n, 1, 1)
    X0_b[:, 0, :] += torch.as_tensor(
        noise(seed, batch, n, nx, mix["x0_sigma"]), dtype=dtype, device=device)
    U0_b = U0[None].repeat(n, 1, 1)
    params_b = {k: v[None].repeat((n,) + (1,) * v.dim())
                for k, v in params.items()}
    return params_b, X0_b, U0_b
