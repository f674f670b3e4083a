"""Unrolled small-matrix Cholesky for batched tiny systems (n <= ~12).

Port of ``dcol_tpu/ops/chol.py``: n is static and tiny, so
Cholesky-Banachiewicz and the two triangular substitutions unroll into one
elementwise op over the batch per scalar of the factorisation.
"""

from __future__ import annotations

import torch


def chol_factor(M, jitter: float = 0.0):
    """Lower-triangular L with L L' = M + jitter * mean(diag(M)) * I.

    M: (..., n, n) symmetric positive definite.  Returns (..., n, n)."""
    n = M.shape[-1]
    if jitter:
        eps = jitter * torch.diagonal(M, dim1=-2, dim2=-1).mean(dim=-1)
        M = M + eps[..., None, None] * torch.eye(n, dtype=M.dtype,
                                                 device=M.device)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    zero = torch.zeros_like(M[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero
                                     for j in range(n)], dim=-1)
                        for i in range(n)], dim=-2)


def chol_solve(L, b):
    """Solve (L L') x = b by unrolled forward/backward substitution.

    L: (..., n, n) lower-triangular; b: (..., n)."""
    n = L.shape[-1]
    rd = [1.0 / L[..., i, i] for i in range(n)]  # each feeds both sweeps
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s * rd[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s * rd[i]
    return torch.stack(x, dim=-1)
