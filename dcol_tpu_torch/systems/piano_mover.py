"""Piano-mover system: a 2-D double-integrator line segment threading three
wall polytopes.  Port of ``dcol_tpu/systems/piano_mover.py`` with the same
hyperparameters and pinned initial controls.

State x = [rx, ry, vx, vy, theta, omega]; control
u = [ax, ay, OMEGA_CONTROL_SCALE * domega].
The robot's planar heading maps to the MRP p = [0, 0, tan(theta/4)] with the
chain rule dp/dtheta = e3 / (4 cos^2(theta/4)).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from dcol_tpu_torch.geometry import primitives as prim
from dcol_tpu_torch.solver.altro import AltroConfig
from dcol_tpu_torch.systems.base import CollisionScene, ProximityOptions, System

_DATA = os.path.join(os.path.dirname(__file__), "data", "fixtures.npz")
# the third control is the angular acceleration times this scale
OMEGA_CONTROL_SCALE = 100.0


@dataclasses.dataclass(frozen=True)
class PianoMover(System):
    def dynamics(self, params, x, u):
        return torch.cat([x[..., 2:4], u[..., :2], x[..., 5:6],
                          u[..., 2:3] / OMEGA_CONTROL_SCALE], dim=-1)

    def robot_pose(self, x):
        r = torch.cat([x[..., :2], torch.zeros_like(x[..., :1])], dim=-1)
        t = torch.tan(x[..., 4:5] / 4.0)
        return r, torch.cat([0.0 * t, 0.0 * t, t], dim=-1)

    def pose_jacobian_rows(self, x, d_r, d_p):
        """Rows of d(1-alpha)/dx with the theta->MRP chain rule."""
        dp_dtheta = 1.0 / (4.0 * torch.cos(x[..., 4] / 4.0) ** 2)
        z = torch.zeros_like(d_r[..., :1])
        return torch.cat([-d_r[..., :2], z, z,
                          (-d_p[..., 2] * dp_dtheta[..., None])[..., None], z],
                         dim=-1)

    # csrc/rollout.cu computes dynamics() above with OMEGA_CONTROL_SCALE
    rollout_kernel = "piano_mover"


def make_system(pdip_tol: float = 1e-6, pdip_iters: int = 30,
                pdip_jitter: float = 0.0, N: int = 80,
                dt: float = 0.1, fd_jacobians: bool = False) -> PianoMover:
    robot = prim.rect_prism(2.5, 0.15, 0.01)            # reference :168
    obstacles = (
        prim.rect_prism(3.0, 3.0, 1.0),
        prim.rect_prism(4.0, 1.0, 1.0),
        prim.rect_prism(1.0, 5.0, 1.1),
    )
    scene = CollisionScene(robot, obstacles,
                           ProximityOptions(pdip_tol, pdip_iters, pdip_jitter))
    return PianoMover(nx=6, nu=3, N=N, dt=dt, scene=scene,
                      fd_jacobians=fd_jacobians)


def make_problem(dtype: torch.dtype = torch.float64, device="cuda",
                 N: int = 80):
    """(system, params, X0, U0, config) for ONE scenario, with the
    reference hyperparameters (:137-219) and pinned initial controls, on
    the card unless ``device`` says otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda is not "
                           "available")
    f32 = dtype == torch.float32
    if f32:  # f32 PDIP conditioning
        sys = make_system(N=N, pdip_tol=2e-5, pdip_jitter=1e-6)
    else:
        sys = make_system(N=N)
    nx, nu = sys.nx, sys.nu
    x0 = np.array([1.5, 1.5, 0, 0, 0, 0])
    xg = np.array([3.5, 3.7, 0, 0, np.deg2rad(90), 0])
    T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                  dtype=dtype, device=device)
    params = {
        "Q": T(np.eye(nx)),
        "R": T(np.diag([1, 1, 0.001])),
        "Qf": T(np.eye(nx)),
        "Xref": T(np.tile(xg, (N, 1))),
        "Uref": T(np.zeros((N - 1, nu))),
        "u_min": T(np.full((nu,), -200.0)),
        "u_max": T(np.full((nu,), 200.0)),
        "obs_r": T([[1.5, 3.5, 0.0], [2.0, 0.5, 0.0], [4.5, 2.5, 0.0]]),
        "obs_p": T(np.zeros((3, 3))),
    }
    cfg = AltroConfig(ls_slack=1e-4 if f32 else 0.0, max_iters=3000,
                      max_ls_iters=20, atol=4e-2, convio_tol=1e-4, rho0=1.0,
                      phi=10.0, reg_min=1e-6, reg_max=1e2)
    X0 = T(np.tile(x0, (N, 1)))
    U0 = T(np.load(_DATA)["piano_U0"][: N - 1])
    return sys, params, X0, U0, cfg
