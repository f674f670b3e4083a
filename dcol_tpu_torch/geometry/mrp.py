"""Modified Rodrigues Parameter (MRP) attitude math on torch tensors.

Port of ``dcol_tpu/geometry/mrp.py``.  Every function broadcasts over leading
batch dims (the last axis is the 3-vector axis) and is differentiable with
``torch.func`` forward mode, which the dynamics and envelope Jacobians use.

    R(p) = I + (8 [p]x^2 + 4 (1 - p'p) [p]x) / (1 + p'p)^2
"""

from __future__ import annotations

import torch


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [w]x with [w]x v = w x v."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def dcm_from_mrp(p: torch.Tensor) -> torch.Tensor:
    """Direction cosine matrix from MRPs, (..., 3) -> (..., 3, 3), using
    [p]x^2 = p p' - (p'p) I."""
    pp = torch.sum(p * p, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    S = skew(p)
    SS = p[..., :, None] * p[..., None, :] - pp * eye
    den = (1.0 + pp) ** 2
    return eye + (8.0 * SS + 4.0 * (1.0 - pp) * S) / den


def mrp_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [w, x, y, z] (..., 4) -> MRP (..., 3)."""
    return q[..., 1:4] / (1.0 + q[..., 0:1])


def mrp_kinematics(p: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """pdot = B(p) omega with
    B(p) = ((1 + p'p)/4) (I + 2 ([p]x^2 + [p]x) / (1 + p'p)), matrix-free."""
    pp = torch.sum(p * p, dim=-1, keepdim=True)
    SSw = p * torch.sum(p * omega, dim=-1, keepdim=True) - pp * omega
    Sw = torch.linalg.cross(p, omega, dim=-1)
    return ((1.0 + pp) / 4.0) * (omega + 2.0 * (SSw + Sw) / (1.0 + pp))
