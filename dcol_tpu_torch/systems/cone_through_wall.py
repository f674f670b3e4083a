"""Cone-through-wall: a 6-DOF rigid-body cone steered (by a wrench) through
the square hole of a wall built from four rotated rectangular prisms.  Port
of ``dcol_tpu/systems/cone_through_wall.py`` with the same obstacles, poses,
hyperparameters and pinned initial controls.

State x = [r(3); v(3); p(3, MRP); omega(3)]; control u = [f(3); tau(3)].
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from dcol_tpu_torch.geometry import primitives as prim
from dcol_tpu_torch.geometry.mrp import mrp_from_quat, mrp_kinematics
from dcol_tpu_torch.solver.altro import AltroConfig
from dcol_tpu_torch.systems.base import (
    CollisionScene, ProximityOptions, System, full_pose_jacobian_rows)
from dcol_tpu_torch.systems.quadrotor import linear_interp_ref

_DATA = os.path.join(os.path.dirname(__file__), "data", "fixtures.npz")

CONE_H = 2.0
CONE_BETA = np.deg2rad(22)
_MASS, _INERTIA = prim.cone_mass_properties(prim.cone(CONE_H, CONE_BETA))
MASS = float(_MASS)
INERTIA_DIAG = np.diag(_INERTIA).copy()


@dataclasses.dataclass(frozen=True)
class ConeThroughWall(System):
    def dynamics(self, params, x, u):
        v = x[..., 3:6]
        p = x[..., 6:9]
        omega = x[..., 9:12]
        f = u[..., :3]
        tau = u[..., 3:6]
        # diagonal inertia: elementwise solve
        Jd = torch.as_tensor(INERTIA_DIAG, dtype=x.dtype, device=x.device)
        omega_dot = (tau - torch.linalg.cross(omega, Jd * omega, dim=-1)) / Jd
        return torch.cat([v, f / MASS, mrp_kinematics(p, omega), omega_dot],
                         dim=-1)

    def robot_pose(self, x):
        return x[..., 0:3], x[..., 6:9]

    def pose_jacobian_rows(self, x, d_r, d_p):
        return full_pose_jacobian_rows(self.nx, d_r, d_p)


def make_system(pdip_tol: float = 1e-6, pdip_iters: int = 30,
                pdip_jitter: float = 0.0, N: int = 60,
                fd_jacobians: bool = False) -> ConeThroughWall:
    obstacles = (
        prim.rect_prism(10.0, 10.0, 1.0),
        prim.rect_prism(10.0, 10.0, 1.0),
        prim.rect_prism(4.1, 4.1, 1.1),
        prim.rect_prism(4.1, 4.1, 1.1),
    )
    scene = CollisionScene(prim.cone(CONE_H, CONE_BETA), obstacles,
                           ProximityOptions(pdip_tol, pdip_iters, pdip_jitter))
    return ConeThroughWall(nx=12, nu=6, N=N, dt=0.1, scene=scene,
                           fd_jacobians=fd_jacobians)


def make_problem(dtype: torch.dtype = torch.float64, device="cuda",
                 N: int = 60):
    """(system, params, X0, U0, config) for ONE scenario, with the
    reference hyperparameters and the pinned seed-2 initial controls, on
    the card unless ``device`` says otherwise.
    Horizons shorter than the reference's 60 knots reuse the leading rows of
    the U0 fixture."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda is not "
                           "available")
    f32 = dtype == torch.float32
    if f32:
        # f32 PDIP conditioning: this system rides the convio_tol = 1e-4
        # boundary in f32, so envelope-gradient accuracy decides
        # convergence; the JAX package found pdip_tol 2e-5 too loose on
        # its accelerator and 1e-5 enough (its commit a820ad9)
        sys = make_system(N=N, pdip_tol=1e-5, pdip_jitter=1e-6)
    else:
        sys = make_system(N=N)
    nx, nu = sys.nx, sys.nu
    cone_U0 = np.load(_DATA)["cone_U0"]
    if N - 1 > cone_U0.shape[0]:
        raise ValueError(
            f"cone_through_wall N={N} exceeds the pinned seed-2 U0 fixture "
            f"horizon ({cone_U0.shape[0] + 1}); pass N <= "
            f"{cone_U0.shape[0] + 1}")
    x0 = np.array([-4, -7, 9, 0.0, 0.0, 0.0, 0, 0, 0, 0, 0, 0])
    xg = np.array([-4.5, 7, 3, 0, 0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0])
    # four wall slabs rotated 90 deg about x
    p_rot = mrp_from_quat(torch.tensor(
        [np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0],
        dtype=torch.float64)).numpy()
    obs_r = np.array([[-6, 0, 5.0], [6, 0, 5.0], [0, 0, 2.05], [0, 0, 7.96]])
    obs_p = np.tile(p_rot, (4, 1))
    T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                  dtype=dtype, device=device)
    params = {
        "Q": T(np.eye(nx)),
        "R": T(np.diag([1.0, 1, 1, 100, 100, 100])),
        "Qf": T(np.eye(nx)),
        "Xref": T(linear_interp_ref(sys.dt, x0, xg, N)),
        "Uref": T(np.zeros((N - 1, nu))),
        "u_min": T(np.full((nu,), -20.0)),
        "u_max": T(np.full((nu,), 20.0)),
        "obs_r": T(obs_r),
        "obs_p": T(obs_p),
    }
    cfg = AltroConfig(ls_slack=1e-4 if f32 else 0.0, max_iters=3000,
                      max_ls_iters=20, atol=1e-1, convio_tol=1e-4, rho0=1.0,
                      phi=10.0, reg_min=1e-6, reg_max=1e2)
    X0 = T(np.tile(x0, (N, 1)))
    U0 = T(cone_U0[: N - 1])
    return sys, params, X0, U0, cfg
