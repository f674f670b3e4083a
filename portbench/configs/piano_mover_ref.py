"""Plain reference of the ``piano_mover`` configuration: the planar double
integrator and the piano's pose, from ``piano_mover.json`` (Tracy, Howell,
Manchester, arXiv:2207.00669, the piano-mover example).  Plain PyTorch in
the arithmetic it is given (:class:`portbench.harness.socp.Arith`); it
imports nothing of the program.

State x = [rx, ry, vx, vy, theta, omega], control u = [ax, ay, s * domega]
with s the configuration's ``omega_control_scale``.
"""

from __future__ import annotations

import torch

from portbench.harness.socp import Arith


class Reference:
    def __init__(self, config: dict):
        self.config = config
        self.dt = config["dt"]
        k = 1.0 / config["plant"]["omega_control_scale"]
        # xdot = A x + B u
        self.A = [[0, 0, 1, 0, 0, 0], [0, 0, 0, 1, 0, 0], [0] * 6, [0] * 6,
                  [0, 0, 0, 0, 0, 1], [0] * 6]
        self.B = [[0, 0, 0], [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 0],
                  [0, 0, k]]

    def dynamics(self, x, u, ar: Arith):
        A = torch.as_tensor(self.A, dtype=ar.dtype, device=x.device)
        B = torch.as_tensor(self.B, dtype=ar.dtype, device=x.device)
        return (ar.mv(A.expand(x.shape[:-1] + (6, 6)), x.to(ar.dtype))
                + ar.mv(B.expand(u.shape[:-1] + (6, 3)), u.to(ar.dtype)))

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
        """World position and rotation (heading theta about z) of the
        piano at states x."""
        x = x.to(ar.dtype)
        th = x[..., 4]
        c, s = torch.cos(th), torch.sin(th)
        z, o = torch.zeros_like(th), torch.ones_like(th)
        r = torch.stack([x[..., 0], x[..., 1], z], -1)
        Q = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                         torch.stack([z, z, o], -1)], -2)
        return r, Q
