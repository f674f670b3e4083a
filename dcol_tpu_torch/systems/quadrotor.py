"""Cluttered-hallway quadrotor: 6-DOF quadrotor (MRP attitude) flying through
11 heterogeneous obstacles.  Port of ``dcol_tpu/systems/quadrotor.py`` with
the same obstacles, poses, hyperparameters and pinned initial controls.

State x = [r(3); v(3); p(3, MRP); omega(3)]; control u = rotor speeds (4).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from dcol_tpu_torch.geometry import primitives as prim
from dcol_tpu_torch.geometry.mrp import dcm_from_mrp, mrp_kinematics
from dcol_tpu_torch.solver.altro import AltroConfig
from dcol_tpu_torch.systems.base import (
    CollisionScene, ProximityOptions, System, full_pose_jacobian_rows)

_DATA = os.path.join(os.path.dirname(__file__), "data", "fixtures.npz")

MASS = 0.5
J_DIAG = np.array([0.0023, 0.0023, 0.004])
GRAVITY = 9.81
ARM_L = 0.1750
KF = 1.0
KM = 0.0245


@dataclasses.dataclass(frozen=True)
class Quadrotor(System):
    def dynamics(self, params, x, u):
        v = x[..., 3:6]
        p = x[..., 6:9]
        omega = x[..., 9:12]
        Q = dcm_from_mrp(p)
        Jd = torch.as_tensor(J_DIAG, dtype=x.dtype, device=x.device)
        # rotor forces clamp to >= 0 (reference :53-56); at the kink the
        # derivative splits 1/2-1/2, as jnp.maximum's does
        F_rot = torch.maximum(torch.zeros_like(u), KF * u)
        M = KM * u
        tau = torch.stack([
            ARM_L * (F_rot[..., 1] - F_rot[..., 3]),
            ARM_L * (F_rot[..., 2] - F_rot[..., 0]),
            M[..., 0] - M[..., 1] + M[..., 2] - M[..., 3],
        ], dim=-1)
        # body thrust is along e3, so Q @ F_body == Q[:, 2] * |F|
        g = torch.as_tensor([0.0, 0.0, -GRAVITY], dtype=x.dtype,
                            device=x.device)
        f_world = MASS * g + Q[..., :, 2] * torch.sum(F_rot, dim=-1,
                                                      keepdim=True)
        omega_dot = (tau - torch.linalg.cross(omega, Jd * omega, dim=-1)) / Jd
        return torch.cat([v, f_world / MASS, mrp_kinematics(p, omega),
                          omega_dot], dim=-1)

    def robot_pose(self, x):
        return x[..., 0:3], x[..., 6:9]

    def pose_jacobian_rows(self, x, d_r, d_p):
        return full_pose_jacobian_rows(self.nx, d_r, d_p)

    # csrc/rollout.cu computes dynamics() above with the module's constants
    rollout_kernel = "quadrotor"


def linear_interp_ref(dt, x0, xg, N):
    """Position/attitude linear interpolation reference (reference
    :192-225): constant velocity, zero angular velocity."""
    t = np.arange(N)[:, None] / (N - 1)
    positions = x0[0:3] + t * (xg[0:3] - x0[0:3])
    attitudes = x0[6:9] + t * (xg[6:9] - x0[6:9])
    velocity = np.tile((xg[0:3] - x0[0:3]) / ((N - 1) * dt), (N, 1))
    omega = np.zeros((N, 3))
    return np.concatenate([positions, velocity, attitudes, omega], axis=1)


def make_system(pdip_tol: float = 1e-6, pdip_iters: int = 30,
                pdip_jitter: float = 0.0, N: int = 100,
                dt: float = 0.08, fd_jacobians: bool = False) -> Quadrotor:
    data = np.load(_DATA)
    A_poly, b_poly = prim.n_sided_polygon(5, 0.6)
    obstacles = (
        prim.cylinder(0.6, 3.0),
        prim.capsule(0.2, 5.0),
        prim.sphere(0.8),
        prim.cone(2.0, np.deg2rad(22)),
        prim.polytope(data["A2"].T, data["b2"]),
        prim.polygon(A_poly, b_poly, 0.2),
        prim.cylinder(1.1, 2.3),
        prim.capsule(0.8, 1.0),
        prim.sphere(0.5),
        prim.rect_prism(20.0, 5.0, 0.2),   # floor
        prim.rect_prism(20.0, 5.0, 0.2),   # ceiling
    )
    scene = CollisionScene(prim.sphere(0.25), obstacles,
                           ProximityOptions(pdip_tol, pdip_iters, pdip_jitter))
    return Quadrotor(nx=12, nu=4, N=N, dt=dt, scene=scene,
                     fd_jacobians=fd_jacobians)


# reference :314-331 (Julia-seed-2 obstacle poses), plus floor/ceiling rows
OBS_R = np.array([
    [-5.0, -0.3597289068234817, 4.087208492428585],
    [-3.75, 2.0547630560640364, 3.3248927294469155],
    [-2.5, 0.01357380155160959, 3.1056516058837307],
    [-1.25, 0.1520302408349855, 2.100626290031169],
    [0.0, 0.27038613194550204, 4.579317307027433],
    [1.25, -0.20563037602802728, 3.7707031750912097],
    [2.5, 1.724189934074888, 3.1527083547286816],
    [3.75, -0.7885513165549604, 2.3533371368422706],
    [5.0, 0.32074771862886275, 4.251199978479224],
    [0.0, 0.0, 0.9],
    [0.0, 0.0, 6.0],
])
OBS_P = np.array([
    [0.9743462834661368, 0.5695654691654629, -0.929297065594203],
    [0.44432216225861665, -0.8131633664490159, 0.8533462452863487],
    [-0.7818142467739891, -1.0606493186561021, -0.6997594248738506],
    [0.09970204047057568, -0.6590733218999884, 0.10747184882042882],
    [-1.178486073522902, -0.5852806292416908, -0.5104503832374265],
    [1.322242556684692, 1.477962368008582, -0.09186250030835676],
    [-1.670756785490579, -1.6504683581003534, 0.9958143390876766],
    [0.40980738483268503, 0.5108420391824778, 0.42272633604120335],
    [1.8822143307659809, -0.7779808480817001, 0.8308676764061569],
    [0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0],
])


def make_problem(dtype: torch.dtype = torch.float64, device="cuda",
                 N: int = 100):
    """(system, params, X0, U0, config) for ONE scenario (params and
    trajectories without the scenario dim; see
    :func:`dcol_tpu_torch.parallel.batch.perturb_scenarios`), on the card
    unless ``device`` says otherwise."""
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
    x0 = np.array([-8, 0, 4, 0, 0, 0.0, 0, 0, 0, 0, 0, 0])
    xg = np.array([8, 0, 4, 0, 0, 0.0, 0, 0, 0, 0, 0, 0])
    T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                  dtype=dtype, device=device)
    params = {
        "Q": T(np.eye(nx)),
        "R": T(np.eye(nu)),
        "Qf": T(np.eye(nx)),
        "Xref": T(linear_interp_ref(sys.dt, x0, xg, N)),
        "Uref": T(np.full((N - 1, nu), GRAVITY * MASS / 4.0)),
        "u_min": T(np.full((nu,), -2000.0)),
        "u_max": T(np.full((nu,), 2000.0)),
        "obs_r": T(OBS_R),
        "obs_p": T(OBS_P),
    }
    cfg = AltroConfig(ls_slack=1e-4 if f32 else 0.0, max_iters=3000,
                      max_ls_iters=20, atol=1e-2, convio_tol=1e-4, rho0=1.0,
                      phi=10.0, reg_min=1e-6, reg_max=1e2)
    X0 = T(np.tile(x0, (N, 1)))
    U0 = T(np.load(_DATA)["quadrotor_U0"][: N - 1])
    return sys, params, X0, U0, cfg
