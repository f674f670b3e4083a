"""Scene visualisation (parity with ``utils/visualize_scene_piano_mover.py``
and ``utils/visualize_scene_quadrotor_and_cone.py``): renders all six
primitive types, the optimized trajectory, and robot snapshots.  Port of
``dcol_tpu/utils/viz.py``: the same functions and files, taking tensors (on
any device) or numpy arrays; matplotlib is imported inside the functions.

2-D top-down for the piano mover; matplotlib 3-D (three camera modes:
side_az_90 / top_down / custom) for the 6-DOF systems."""

from __future__ import annotations

import itertools
import os

import numpy as np

import torch

from dcol_tpu_torch.geometry import primitives as prim
from dcol_tpu_torch.utils.plots import to_numpy


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _dcm(p):
    # host-side numpy MRP->DCM (matches geometry.mrp.dcm_from_mrp; plain
    # numpy so the f64 pose math never touches the device or the x64 flag)
    p = np.asarray(p, float)
    pp = float(p @ p)
    S = np.array([[0.0, -p[2], p[1]],
                  [p[2], 0.0, -p[0]],
                  [-p[1], p[0], 0.0]])
    den = (1.0 + pp) ** 2
    return np.eye(3) + (8.0 * (S @ S) + 4.0 * (1.0 - pp) * S) / den


def polytope_vertices(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Enumerate vertices of {x : Ax <= b} by intersecting plane triples
    (same idea as visualize_scene_quadrotor_and_cone.py:20-55)."""
    verts = []
    n = A.shape[0]
    for i, j, k in itertools.combinations(range(n), 3):
        M = A[[i, j, k]]
        if abs(np.linalg.det(M)) < 1e-10:
            continue
        v = np.linalg.solve(M, b[[i, j, k]])
        if np.all(A @ v <= b + 1e-8):
            verts.append(v)
    return np.unique(np.round(np.asarray(verts), 9), axis=0)


# ---------------------------------------------------------------------------
# 3-D primitive surfaces (body frame), returned as (X, Y, Z) grids or tri-lists
# ---------------------------------------------------------------------------

def _surf_sphere(R, n=16):
    u, v = np.meshgrid(np.linspace(0, 2 * np.pi, n), np.linspace(0, np.pi, n))
    return R * np.cos(u) * np.sin(v), R * np.sin(u) * np.sin(v), R * np.cos(v)


def _surf_cylinder(R, L, n=16):
    # axis = body x (cf. cylinder_problem_matrices bx = Q e1)
    x, th = np.meshgrid(np.linspace(-L / 2, L / 2, 2), np.linspace(0, 2 * np.pi, n))
    return x, R * np.cos(th), R * np.sin(th)


def _surf_capsule(R, L, n=16):
    xs, ys, zs = _surf_cylinder(R, L, n)
    sx, sy, sz = _surf_sphere(R, n)
    return [(xs, ys, zs), (sx + L / 2, sy, sz), (sx - L / 2, sy, sz)]


def _surf_cone(H, beta, n=16):
    # apex at x = +3H/4, base at x = -H/4 (DCOL convention: the cone's
    # centroid is the body origin; cf. cone_problem_matrices)
    rad = np.tan(beta)
    x, th = np.meshgrid(np.linspace(-H / 4, 3 * H / 4, 2), np.linspace(0, 2 * np.pi, n))
    rr = rad * (3 * H / 4 - x)
    return x, rr * np.cos(th), rr * np.sin(th)


def _plot_shape3d(ax, shape: prim.Shape, r, p, color, alpha=0.45):
    Q = _dcm(p)
    r = np.asarray(r, float)

    def world(x, y, z):
        pts = np.stack([x.ravel(), y.ravel(), z.ravel()])
        w = Q @ pts + r[:, None]
        return (w[0].reshape(x.shape), w[1].reshape(x.shape),
                w[2].reshape(x.shape))

    k = shape.kind
    if k == prim.SPHERE:
        ax.plot_surface(*world(*_surf_sphere(shape.R)), color=color, alpha=alpha)
    elif k == prim.CYLINDER:
        ax.plot_surface(*world(*_surf_cylinder(shape.R, shape.L)), color=color,
                        alpha=alpha)
    elif k == prim.CAPSULE:
        for s in _surf_capsule(shape.R, shape.L):
            ax.plot_surface(*world(*s), color=color, alpha=alpha)
    elif k == prim.CONE:
        ax.plot_surface(*world(*_surf_cone(shape.H, shape.beta)), color=color,
                        alpha=alpha)
    elif k == prim.POLYTOPE:
        from scipy.spatial import ConvexHull

        V = polytope_vertices(shape.A_np(), shape.b_np())
        Vw = (Q @ V.T + r[:, None]).T
        hull = ConvexHull(Vw)
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        faces = [Vw[s] for s in hull.simplices]
        ax.add_collection3d(
            Poly3DCollection(faces, alpha=alpha, facecolor=color,
                             edgecolor="k", linewidths=0.2))
    elif k == prim.POLYGON:
        # 2-D H-rep polygon in the body x-y plane, padded by radius R
        A2, b2 = shape.A_np(), shape.b_np()
        nf = A2.shape[0]
        verts2 = []
        for i in range(nf):
            j = (i + 1) % nf
            M = A2[[i, j]]
            if abs(np.linalg.det(M)) < 1e-12:
                continue
            verts2.append(np.linalg.solve(M, b2[[i, j]] + shape.R))
        V = np.array([[v[0], v[1], 0.0] for v in verts2])
        Vw = (Q @ V.T + r[:, None]).T
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        ax.add_collection3d(
            Poly3DCollection([Vw], alpha=alpha, facecolor=color,
                             edgecolor="k", linewidths=0.4))


_VIEWS = {"side_az_90": (0, 90), "top_down": (90, -90), "custom": (25, -60)}


def visualize_scene_3d(system: str, sys_, params, X, view_mode="custom",
                       n_snapshots=8):
    plt = _mpl()
    X = to_numpy(X)
    d = os.path.join("result_images", system)
    os.makedirs(d, exist_ok=True)
    fig = plt.figure(figsize=(9, 8))
    ax = fig.add_subplot(111, projection="3d")
    obs_r = to_numpy(params["obs_r"])
    obs_p = to_numpy(params["obs_p"])
    colors = plt.cm.tab20(np.linspace(0, 1, len(sys_.scene.obstacles)))
    for i, obs in enumerate(sys_.scene.obstacles):
        _plot_shape3d(ax, obs, obs_r[i], obs_p[i], colors[i])
    ax.plot(X[:, 0], X[:, 1], X[:, 2], "k--", lw=1.5)
    idx = np.linspace(0, X.shape[0] - 1, n_snapshots).astype(int)
    for t in idx:
        r, p = sys_.robot_pose(torch.as_tensor(X[t]))
        _plot_shape3d(ax, sys_.scene.robot, r.numpy(), p.numpy(), "red",
                      alpha=0.8)
    elev, azim = _VIEWS[view_mode]
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect([1, 1, 1])
    lo, hi = X[:, :3].min() - 3, X[:, :3].max() + 3
    ax.set_xlim(lo, hi); ax.set_ylim(lo, hi); ax.set_zlim(lo, hi)
    fig.tight_layout()
    fig.savefig(os.path.join(d, f"scene_{view_mode}.png"), dpi=120)
    plt.close(fig)


def visualize_scene_piano(system: str, sys_, params, X, n_frames=9):
    """Top-down renders at sampled intervals
    (cf. visualize_scene_piano_mover.py:11-117)."""
    plt = _mpl()
    X = to_numpy(X)
    d = os.path.join("result_images", system)
    os.makedirs(d, exist_ok=True)
    obs_r = to_numpy(params["obs_r"])
    fig, ax = plt.subplots(figsize=(7, 7))
    for i, obs in enumerate(sys_.scene.obstacles):
        A, b = obs.A_np(), obs.b_np()
        # axis-aligned rect prism: extents from b = [l/2, w/2, h/2]*2
        lx, wy = b[0] * 2, b[1] * 2
        ax.add_patch(plt.Rectangle(
            (obs_r[i, 0] - lx / 2, obs_r[i, 1] - wy / 2), lx, wy,
            color="steelblue", alpha=0.6))
    ax.plot(X[:, 0], X[:, 1], "k--", lw=1)
    robot = sys_.scene.robot
    L = robot.b_np()[0] * 2
    idx = np.linspace(0, X.shape[0] - 1, n_frames).astype(int)
    for t in idx:
        cx, cy, th = X[t, 0], X[t, 1], X[t, 4]
        dx, dy = np.cos(th) * L / 2, np.sin(th) * L / 2
        ax.plot([cx - dx, cx + dx], [cy - dy, cy + dy], "r-", lw=3, alpha=0.8)
    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(d, "scene_topdown.png"), dpi=120)
    plt.close(fig)


def visualize_scene(system: str, sys_, params, st, member: int = 0):
    """Scene renders of scenario ``member`` of a batched state; ``params``
    is that scenario's dict (without the scenario dim)."""
    X = st.X[member]
    if system == "piano_mover":
        visualize_scene_piano(system, sys_, params, X)
    else:
        for view in _VIEWS:
            visualize_scene_3d(system, sys_, params, X, view_mode=view)
