"""System protocol + collision-scene machinery shared by all systems.

Port of ``dcol_tpu/systems/base.py``.  A :class:`System` is a static object
(frozen dataclass) and all run-time data (references, bounds, obstacle poses)
lives in a ``params`` dict of tensors with a leading scenario dim S.  Every
trajectory function takes states with leading dims (S, T).

Collision constraints: one :class:`CollisionScene` per system holds the robot
shape and the obstacle shapes, grouped by their EXACT pair layout
(:attr:`CollisionScene.groups`).  Each group's (scenarios x knots x
obstacles) pair problems are assembled together and solved as ONE batched
PDIP call; gradients come from the envelope theorem with the solution frozen.

:meth:`CollisionScene._solve` dispatches by the tensors' device: CPU tensors
take the plain PyTorch solver, CUDA tensors the hand-written kernel, which
raises if it cannot run.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Tuple

import torch
import torch.func

from dcol_tpu_torch.geometry import assembly
from dcol_tpu_torch.geometry.primitives import Shape
from dcol_tpu_torch.ops.cones import ConeLayout
from dcol_tpu_torch.ops.pdip import solve_socp
from dcol_tpu_torch.ops.pdip_cuda import solve_socp_cuda


_JVP_LOCK = threading.Lock()


def lagrangian_gx(G, x):
    """G x of each problem, G (..., nr, nv) and x (..., nv), as the JAX
    package forms it (``dcol_tpu/systems/base.py``, ``lag_vec``): products
    summed over the short nv dim.  A batched matmul would round a problem
    by its position in the batch on the card, so identical scenarios in
    one batch would part (``tools/replicas.py``)."""
    return torch.sum(G * x[..., None, :], dim=-1)


def jvp(fn, primals, tangents):
    """``torch.func.jvp`` under a process-wide lock.  Forward-mode AD levels
    are global to the process, so two host threads inside ``jvp`` at once
    (the scenario mesh runs one a device) would exit each other's level."""
    with _JVP_LOCK:
        return torch.func.jvp(fn, primals, tangents)


@dataclasses.dataclass(frozen=True)
class ProximityOptions:
    tol: float = 1e-6        # reference pdip_tol (proximity/proximity.py:6)
    max_iters: int = 30
    jitter: float = 0.0
    # Interior margin for warm starts: a previous optimum's (s, z) sit at the
    # cone boundary, where NT scaling is ill-conditioned in f32, so the warm
    # start shifts them inward by this much before re-solving.
    warm_margin: float = 1e-3
    # Margin for the backward pass's POLISH solve: it re-solves at the SAME
    # trajectory its warm start converged at, so a smaller shift suffices and
    # saves about one Mehrotra iteration per polish batch.
    polish_margin: float = 1e-4


@dataclasses.dataclass(frozen=True)
class CollisionScene:
    robot: Shape
    obstacles: Tuple[Shape, ...]
    opts: ProximityOptions = ProximityOptions()

    @property
    def n_obs(self) -> int:
        return len(self.obstacles)

    # -- obstacle groups (exact layouts, zero padding rows) ----------------
    @property
    def groups(self) -> Tuple[Tuple[assembly.PairLayout, Tuple[int, ...]], ...]:
        """Obstacles grouped by their EXACT pair layout, in first-seen
        order; each group is one batched solve (one kernel launch)."""
        groups = []  # [(PairLayout, [obstacle indices])]
        for i, obs in enumerate(self.obstacles):
            lay = assembly.exact_layout(self.robot, obs)
            for g in groups:
                if g[0] == lay:
                    g[1].append(i)
                    break
            else:
                groups.append((lay, [i]))
        return tuple((lay, tuple(idx)) for lay, idx in groups)

    @property
    def group_order(self) -> Tuple[int, ...]:
        """Obstacle indices in grouped order (concatenation of the groups)."""
        return tuple(i for _, idx in self.groups for i in idx)

    @property
    def inv_perm(self) -> Tuple[int, ...]:
        """Permutation taking grouped-order columns back to obstacle order."""
        order = self.group_order
        inv = [0] * len(order)
        for pos, i in enumerate(order):
            inv[i] = pos
        return tuple(inv)

    # -- assembly ---------------------------------------------------------
    def assemble_groups(self, r, p, obs_r, obs_p):
        """Per-group stacked problems.  r, p: robot poses (..., 3);
        obs_r, obs_p: (..., n_obs, 3) with batch dims broadcastable against
        r's.  Returns one (c (..., n_g, nv), G (..., n_g, nr, nv),
        h (..., n_g, nr)) per group."""
        out = []
        for lay, idx in self.groups:
            pairs = [assembly.assemble_pair(
                self.robot, self.obstacles[i], lay, r, p,
                obs_r[..., i, :], obs_p[..., i, :]) for i in idx]
            out.append(tuple(torch.stack([q[k] for q in pairs], dim=d)
                             for k, d in enumerate((-2, -3, -2))))
        return out

    # -- solver dispatch --------------------------------------------------
    def _solve(self, c, G, h, lay: ConeLayout, warm=None, skip=None,
               margin=None):
        """Solve a flat batch of pair problems: the kernel for CUDA
        tensors, the plain version for CPU tensors."""
        solver = solve_socp_cuda if G.is_cuda else solve_socp
        wm = self.opts.warm_margin if margin is None else margin
        return solver(c, G, h, lay, tol=self.opts.tol,
                      max_iters=self.opts.max_iters, jitter=self.opts.jitter,
                      warm=warm, skip=skip, warm_margin=wm)

    def _solve_groups_traj(self, rs, ps, obs_r, obs_p, warm=None, skip=None,
                           margin=None):
        """One batched solve PER GROUP over trajectories of poses
        rs/ps (S, T, 3); obs_r/obs_p (S, n_obs, 3).  Returns (per-group
        solutions over flat (S*T*n_g) batches, warm tuple of per-group
        (x, s, z) shaped (S, T*n_g, .)).  ``skip``: (S,) bool marking
        scenarios whose results are discarded."""
        S, T = rs.shape[:2]
        grouped = self.assemble_groups(rs, ps, obs_r[:, None], obs_p[:, None])
        sols, new_warm = [], []
        for gi, (lay, idx) in enumerate(self.groups):
            n_g = len(idx)
            B = S * T * n_g
            c, G, h = (a.reshape((B,) + a.shape[3:]) for a in grouped[gi])
            w = None
            if warm is not None:
                w = tuple(a.reshape((B,) + a.shape[2:]) for a in warm[gi])
            sk = None
            if skip is not None:
                sk = skip[:, None].expand(S, T * n_g).reshape(B)
            sol = self._solve(c, G, h, ConeLayout(lay.n_ort, lay.s1, lay.s2),
                              warm=w, skip=sk, margin=margin)
            sols.append(sol)
            new_warm.append(tuple(a.reshape(S, T * n_g, -1)
                                  for a in (sol.x, sol.s, sol.z)))
        return sols, tuple(new_warm)

    def _gather_cols(self, per_group):
        """Concatenate per-group (..., n_g) arrays and restore obstacle
        order on the last axis."""
        cat = torch.cat(per_group, dim=-1)
        return cat[..., list(self.inv_perm)]

    # -- proximity values -------------------------------------------------
    def alphas(self, r, p, obs_r, obs_p):
        """(n_obs,) proximity alphas for one robot pose r, p (3,) against
        obstacles obs_r, obs_p (n_obs, 3): :meth:`alphas_traj` at S = T = 1."""
        a, _ = self.alphas_traj(r[None, None], p[None, None], obs_r[None],
                                obs_p[None])
        return a[0, 0]

    def alphas_traj(self, rs, ps, obs_r, obs_p, warm=None, skip=None):
        """(alphas (S, T, n_obs), solver warm state) for robot poses
        rs/ps (S, T, 3)."""
        S, T = rs.shape[:2]
        sols, new_warm = self._solve_groups_traj(rs, ps, obs_r, obs_p, warm,
                                                 skip=skip)
        a = self._gather_cols([s.x[:, 3].reshape(S, T, -1) for s in sols])
        return a, new_warm

    def alphas_and_grads_traj(self, rs, ps, obs_r, obs_p, warm=None,
                              skip=None, margin=None):
        """(alphas (S, T, n_obs), d_r (S, T, n_obs, 3), d_p (S, T, n_obs, 3),
        warm) in one set of group solves; gradients by the envelope theorem
        with (x*, z*) frozen."""
        S, T = rs.shape[:2]
        sols, new_warm = self._solve_groups_traj(rs, ps, obs_r, obs_p, warm,
                                                 skip=skip, margin=margin)
        xs = tuple(s.x.detach().reshape(S, T, -1, s.x.shape[-1]) for s in sols)
        zs = tuple(s.z.detach().reshape(S, T, -1, s.z.shape[-1]) for s in sols)
        d_r, d_p = self._envelope_grads(rs, ps, obs_r, obs_p, xs, zs)
        alphas = self._gather_cols([x[..., 3] for x in xs])
        return alphas, d_r, d_p, new_warm

    def alphas_and_grads(self, r, p, obs_r, obs_p):
        """Single-pose :meth:`alphas_and_grads_traj`: (alpha (n_obs,),
        d_r (n_obs, 3), d_p (n_obs, 3))."""
        a, d_r, d_p, _ = self.alphas_and_grads_traj(
            r[None, None], p[None, None], obs_r[None], obs_p[None])
        return a[0, 0], d_r[0, 0], d_p[0, 0]

    def _envelope_grads(self, rs, ps, obs_r, obs_p, xs, zs):
        """d alpha / d(r, p) per (scenario, knot, obstacle) with (x, z)
        frozen: the Lagrangian z'(G x - h) differentiated in forward mode
        over the 6 pose dims.  Each knot's Lagrangian depends on that knot's
        pose only, so the 6 tangent directions ride one leading batch dim of
        size 6 through a single ``jvp``."""
        dt, dev = rs.dtype, rs.device
        basis = torch.eye(6, dtype=dt, device=dev)[:, None, None, :]
        shape6 = (6,) + rs.shape
        tr = basis[..., :3].expand(shape6).contiguous()
        tp = basis[..., 3:].expand(shape6).contiguous()

        def lag(r_, p_):
            grouped = self.assemble_groups(r_, p_, obs_r[:, None],
                                           obs_p[:, None])
            lags = []
            for gi, (_, G_, h_) in enumerate(grouped):
                Gx = lagrangian_gx(G_, xs[gi])
                lags.append(torch.sum(zs[gi] * (Gx - h_), dim=-1))
            return self._gather_cols(lags)

        _, d = jvp(lag, (rs.expand(shape6).contiguous(),
                         ps.expand(shape6).contiguous()), (tr, tp))
        d = d.permute(1, 2, 3, 0)  # (S, T, n_obs, 6)
        return d[..., :3], d[..., 3:]


@dataclasses.dataclass(frozen=True)
class System:
    """Static system description.  Subclasses define the continuous
    dynamics, the robot pose of a state, and the map from pose gradients to
    state-Jacobian rows; control bounds and collision constraints are
    shared.

    ``fd_jacobians``: the backward pass takes the reference's
    forward-difference dynamics Jacobians (step ``solver.altro.FD_DELTA``,
    ALTRO.py:77-100) instead of exact forward-mode AD.  Exact AD is the
    default (better conditioned); FD mode reproduces the reference's
    iterate path on nonlinear systems (see
    ``solver.altro.dynamics_jacobians``)."""

    nx: int
    nu: int
    N: int
    dt: float
    scene: CollisionScene
    fd_jacobians: bool = False

    @property
    def ncx(self) -> int:
        return self.scene.n_obs

    @property
    def ncu(self) -> int:
        return 2 * self.nu

    # -- dynamics ---------------------------------------------------------
    def dynamics(self, params, x, u):
        """Continuous dynamics over leading batch dims."""
        raise NotImplementedError

    def discrete_dynamics(self, params, x, u):
        """RK4, matching the reference integrator."""
        dt = self.dt
        k1 = dt * self.dynamics(params, x, u)
        k2 = dt * self.dynamics(params, x + 0.5 * k1, u)
        k3 = dt * self.dynamics(params, x + 0.5 * k2, u)
        k4 = dt * self.dynamics(params, x + k3, u)
        return x + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0

    # -- robot pose from state -------------------------------------------
    def robot_pose(self, x):
        """(r, p) of the robot primitive for states x (..., nx)."""
        raise NotImplementedError

    def pose_jacobian_rows(self, x, d_r, d_p):
        """Constraint-Jacobian rows d(1 - alpha)/dx, (..., n_obs, nx)."""
        raise NotImplementedError

    # -- state inequality constraints: h = 1 - alpha ---------------------
    def constraints_x(self, params, x):
        """(ncx,) constraint values for one state x (nx,); ``params`` of one
        scenario (no scenario dim, as ``make_problem`` returns them)."""
        r, p = self.robot_pose(x)
        return 1.0 - self.scene.alphas(r, p, params["obs_r"], params["obs_p"])

    def constraints_x_traj(self, params, X, warm=None, skip=None):
        """((S, T, ncx) constraint values, solver warm state) for state
        trajectories X (S, T, nx).  ``skip``: (S,) bool marking scenarios
        whose results are discarded (lock-step line search)."""
        rs, ps = self.robot_pose(X)
        a, new_warm = self.scene.alphas_traj(
            rs, ps, params["obs_r"], params["obs_p"], warm=warm, skip=skip)
        return 1.0 - a, new_warm

    def constraints_x_vg(self, params, x):
        """(h (ncx,), dh/dx (ncx, nx)) for one state x (nx,) in one solve;
        ``params`` of one scenario."""
        r, p = self.robot_pose(x)
        a, d_r, d_p = self.scene.alphas_and_grads(
            r, p, params["obs_r"], params["obs_p"])
        return 1.0 - a, self.pose_jacobian_rows(x, d_r, d_p)

    def constraints_x_vg_traj(self, params, X, warm=None, skip=None):
        """(h (S, T, ncx), dh/dx (S, T, ncx, nx), warm).  This is the
        backward pass's POLISH path: with a warm start (the accepted
        candidate's converged solution at exactly this X) the re-solve uses
        the smaller ``polish_margin``."""
        rs, ps = self.robot_pose(X)
        margin = self.scene.opts.polish_margin if warm is not None else None
        a, d_r, d_p, new_warm = self.scene.alphas_and_grads_traj(
            rs, ps, params["obs_r"], params["obs_p"], warm=warm, skip=skip,
            margin=margin)
        return 1.0 - a, self.pose_jacobian_rows(X, d_r, d_p), new_warm

    # -- control bounds ---------------------------------------------------
    def constraints_u(self, params, u):
        """[u - u_max; u_min - u] for controls u (S, ..., nu)."""
        u_max = scenario_view(params["u_max"], u.dim())
        u_min = scenario_view(params["u_min"], u.dim())
        return torch.cat([u - u_max, u_min - u], dim=-1)

    def constraints_u_grad(self, dtype, device):
        eye = torch.eye(self.nu, dtype=dtype, device=device)
        return torch.cat([eye, -eye], dim=0)


def scenario_view(a, ndim: int):
    """View a (S, *rest) tensor with singleton dims after S so it broadcasts
    against a tensor of ``ndim`` dims whose trailing dims match ``rest``."""
    return a.reshape(a.shape[:1] + (1,) * (ndim - a.dim()) + a.shape[1:])


def full_pose_jacobian_rows(nx: int, d_r, d_p):
    """Rows [-d_r, 0_3, -d_p, 0_3] for systems with state [r; v; p; w]."""
    zeros = torch.zeros_like(d_r)
    J = torch.cat([-d_r, zeros, -d_p, zeros], dim=-1)
    if J.shape[-1] != nx:
        raise ValueError(f"pose rows have {J.shape[-1]} columns, nx={nx}")
    return J
