"""Plain reference of the ``quad_hallway`` configuration: the quadrotor's
rigid-body dynamics and the robot's pose, from the constants of
``quad_hallway.json`` (Tracy, Howell, Manchester, arXiv:2207.00669, the
quadrotor example).  Plain PyTorch in the arithmetic it is given
(:class:`portbench.harness.socp.Arith`); it imports nothing of the program.

State x = [r (3), v (3), p (3, modified Rodrigues parameters), omega (3)],
control u = the four rotor speeds.
"""

from __future__ import annotations

import torch

from portbench.harness.socp import Arith, dcm_from_mrp


class Reference:
    def __init__(self, config: dict):
        self.config = config
        self.dt = config["dt"]
        pl = config["plant"]
        self.mass, self.g = pl["mass"], pl["gravity"]
        self.J = pl["J_diag"]
        L, km = pl["arm_length"], pl["km"]
        self.kf = pl["kf"]
        # body torque = MF F + Mu u: arm torques from the (clamped) rotor
        # forces, the yaw torque from the rotor speeds
        self.MF = [[0.0, L, 0.0, -L], [-L, 0.0, L, 0.0], [0.0, 0.0, 0.0, 0.0]]
        self.Mu = [[0.0] * 4, [0.0] * 4, [km, -km, km, -km]]

    def _const(self, a, ar: Arith, like):
        return torch.as_tensor(a, dtype=ar.dtype, device=like.device)

    def dynamics(self, x, u, ar: Arith):
        x, u = x.to(ar.dtype), u.to(ar.dtype)
        v, p, w = x[..., 3:6], x[..., 6:9], x[..., 9:12]
        F = torch.clamp(self.kf * u, min=0.0)
        thrust = torch.zeros_like(v)
        thrust[..., 2] = F.sum(-1)
        Q = dcm_from_mrp(p, ar)
        acc = ar.mv(Q, thrust) / self.mass
        acc[..., 2] -= self.g
        J = torch.diag(self._const(self.J, ar, x))
        Jinv = torch.diag(1.0 / self._const(self.J, ar, x))
        tau = (ar.mv(self._const(self.MF, ar, x).expand(F.shape[:-1] + (3, 4)), F)
               + ar.mv(self._const(self.Mu, ar, x).expand(u.shape[:-1] + (3, 4)), u))
        Jw = ar.mv(J.expand(w.shape + (3,)), w)
        wdot = ar.mv(Jinv.expand(w.shape + (3,)), tau - torch.linalg.cross(w, Jw, dim=-1))
        pp = (p * p).sum(-1)[..., None, None]
        eye = torch.eye(3, dtype=ar.dtype, device=x.device)
        z = torch.zeros_like(p[..., 0])
        S = torch.stack([torch.stack([z, -p[..., 2], p[..., 1]], -1),
                         torch.stack([p[..., 2], z, -p[..., 0]], -1),
                         torch.stack([-p[..., 1], p[..., 0], z], -1)], -2)
        Bp = 0.25 * ((1.0 - pp) * eye + 2.0 * S + 2.0 * p[..., :, None] * p[..., None, :])
        pdot = ar.mv(Bp, w)
        return torch.cat([v, acc, pdot, wdot], dim=-1)

    def step(self, x, u, ar: Arith):
        """One RK4 step of length dt."""
        dt = self.dt
        x = x.to(ar.dtype)
        k1 = dt * self.dynamics(x, u, ar)
        k2 = dt * self.dynamics(x + 0.5 * k1, u, ar)
        k3 = dt * self.dynamics(x + 0.5 * k2, u, ar)
        k4 = dt * self.dynamics(x + k3, u, ar)
        return x + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0

    def robot_pose(self, x, ar: Arith):
        """World position and rotation of the robot shape at states x."""
        x = x.to(ar.dtype)
        return x[..., 0:3], dcm_from_mrp(x[..., 6:9], ar)
