"""Diagnostic plots (parity with the reference's ``utils/plots.py``):
cost curve, state/control trajectories, constraint violations, and
regularization curve, written under ``result_images/<system>/``.  Port of
``dcol_tpu/utils/plots.py``: the same functions and files, taking tensors
(on any device) or numpy arrays.

Host-side matplotlib over the solver's stacked per-iteration metrics (the
solver records them in the state's ring buffer instead of plotting
mid-solve like the reference does, ALTRO.py:424-425).  matplotlib is
imported inside the functions, so nothing else of the port needs it."""

from __future__ import annotations

import os

import numpy as np


def to_numpy(a) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _outdir(system: str, sub: str = "") -> str:
    d = os.path.join("result_images", system, sub) if sub else os.path.join(
        "result_images", system)
    os.makedirs(d, exist_ok=True)
    return d


def mrp_to_euler(p):
    """MRP -> roll/pitch/yaw for plotting (cf. utils/plots.py:11-45)."""
    p = to_numpy(p)
    n2 = (p**2).sum(-1, keepdims=True)
    q_w = (1 - n2) / (1 + n2)
    q_xyz = 2 * p / (1 + n2)
    w, x, y, z = q_w[..., 0], q_xyz[..., 0], q_xyz[..., 1], q_xyz[..., 2]
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x**2 + y**2))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y**2 + z**2))
    return np.stack([roll, pitch, yaw], axis=-1)


def plot_cost(system: str, J: np.ndarray):
    plt = _mpl()
    d = _outdir(system, "costs")
    plt.figure(figsize=(7, 4))
    plt.plot(J)
    plt.xlabel("iteration")
    plt.ylabel("augmented-Lagrangian cost J")
    plt.yscale("log")
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(os.path.join(d, "cost.png"), dpi=120)
    plt.close()


def plot_regularization(system: str, reg: np.ndarray, rho: np.ndarray):
    plt = _mpl()
    d = _outdir(system)
    plt.figure(figsize=(7, 4))
    plt.semilogy(reg, label="reg")
    plt.semilogy(rho, label="rho (AL penalty)")
    plt.xlabel("iteration")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(os.path.join(d, "regularization.png"), dpi=120)
    plt.close()


def plot_constraint_violation(system: str, convio: np.ndarray, kmax: np.ndarray):
    plt = _mpl()
    d = _outdir(system)
    plt.figure(figsize=(7, 4))
    plt.semilogy(np.maximum(convio, 1e-16), label="convio")
    plt.semilogy(np.maximum(kmax, 1e-16), label="|d| (kmax)")
    plt.xlabel("iteration")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.tight_layout()
    plt.savefig(os.path.join(d, "constraint_violations.png"), dpi=120)
    plt.close()


def plot_per_constraint_violations(system: str, hx_hist, hu_hist):
    """Per-constraint violation curves over iterations — parity with the
    reference's ``plot_constraint_violations`` (``utils/plots.py:288-322``;
    imported by its ALTRO but never called — SURVEY.md §7.5).  ``hx_hist`` /
    ``hu_hist`` are (iters, ncx) / (iters, ncu) arrays; each point is that
    constraint's maximum value over the horizon at that iteration (h <= 0
    satisfied).  Rendered as ``state_constraints.png`` /
    ``control_constraints.png`` under ``result_images/<system>/``."""
    plt = _mpl()
    d = _outdir(system)
    for stem, hist, kind in (("state_constraints", hx_hist, "State"),
                             ("control_constraints", hu_hist, "Control")):
        hist = np.stack([to_numpy(h) for h in hist])
        plt.figure(figsize=(12, 6))
        for i in range(hist.shape[1]):
            plt.plot(hist[:, i], label=f"{kind} Constraint {i + 1}")
        plt.xlabel("Iteration")
        plt.ylabel("Constraint Violation")
        plt.title(f"{kind} Constraint Violations Over Iterations")
        plt.legend(ncol=2, fontsize=8)
        plt.grid()
        plt.savefig(os.path.join(d, f"{stem}.png"), dpi=100)
        plt.close()


def plot_trajectories(system: str, X: np.ndarray, U: np.ndarray, dt: float):
    plt = _mpl()
    d = _outdir(system)
    t = np.arange(X.shape[0]) * dt
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    nx = X.shape[1]
    if nx >= 12:  # [r; v; p; w] systems
        axes[0, 0].plot(t, X[:, 0:3]); axes[0, 0].set_title("position")
        axes[0, 1].plot(t, X[:, 3:6]); axes[0, 1].set_title("velocity")
        axes[1, 0].plot(t, np.rad2deg(mrp_to_euler(X[:, 6:9])))
        axes[1, 0].set_title("attitude (deg)")
    else:  # piano mover
        axes[0, 0].plot(t, X[:, 0:2]); axes[0, 0].set_title("position")
        axes[0, 1].plot(t, X[:, 2:4]); axes[0, 1].set_title("velocity")
        axes[1, 0].plot(t, np.rad2deg(X[:, 4])); axes[1, 0].set_title("theta (deg)")
    axes[1, 1].plot(t[:-1], U); axes[1, 1].set_title("controls")
    for ax in axes.flat:
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(d, "trajectories.png"), dpi=120)
    plt.close(fig)


_STATE_PANELS = {
    # system -> (pos idx, vel idx, orient idx, angvel idx, orient_is_mrp)
    "piano_mover": ([0, 1], [2, 3], [4], [5], False),
    "quadrotor": ([0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11], True),
    "coneThroughWall": ([0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11], True),
}

_CONTROL_PANELS = {
    # system -> list of (filename stem, indices, labels, ylabel, title)
    "piano_mover": [
        ("linear_acceleration", [0, 1], [r"$a_{v_x}$", r"$a_{v_y}$"],
         "Linear Acceleration [m/s²]", "Linear Acceleration Trajectories"),
        ("angular_acceleration", [2], [r"$a_{\omega}$"],
         "Angular Acceleration [deg/s²]", "Angular Acceleration Trajectories"),
    ],
    "coneThroughWall": [
        ("forces", [0, 1, 2], [r"$f_1$", r"$f_2$", r"$f_3$"],
         "Forces [N]", "Force Trajectories"),
        ("torques", [3, 4, 5], [r"$\tau_1$", r"$\tau_2$", r"$\tau_3$"],
         "Torques [N·m]", "Torque Trajectories"),
    ],
    "quadrotor": [
        ("control_trajectories", [0, 1, 2, 3],
         [r"$w_1$", r"$w_2$", r"$w_3$", r"$w_4$"],
         "Rotor Angular Velocity [rad/s]", "Control Trajectories"),
    ],
}


def plot_trajectory_history(system: str, X, U, dt: float, it: int):
    """Per-iteration state/control trajectory snapshots — parity with the
    reference's ``utils/plots.py:76-286`` (four state panels: position,
    linear velocity, orientation, angular velocity; per-system control
    splits), written as ``..._iter_{it}.png`` under
    ``result_images/<system>/{state,control}_trajectories_history/``."""
    plt = _mpl()
    X, U = to_numpy(X), to_numpy(U)
    t = np.arange(X.shape[0]) * dt
    tu = t[:-1]
    d_x = _outdir(system, "state_trajectories_history")
    d_u = _outdir(system, "control_trajectories_history")

    pos, vel, ori, angv, is_mrp = _STATE_PANELS[system]
    panels = [
        ("position", pos, "Position [m]", "Position Trajectories", X),
        ("velocity", vel, "Linear Velocity [m/s]",
         "Linear Velocity Trajectories", X),
        ("angular_velocity", angv, "Angular Velocity [rad/s]",
         "Angular Velocity Trajectories", X),
    ]
    axis_labels = ["$x$", "$y$", "$z$"], ["$v_x$", "$v_y$", "$v_z$"], \
        ["$\\omega_x$", "$\\omega_y$", "$\\omega_z$"]
    if system == "piano_mover":
        axis_labels = ["$x$", "$y$"], ["$v_x$", "$v_y$"], ["$\\omega$"]
    for (stem, idx, ylab, title, arr), labs in zip(panels, axis_labels):
        plt.figure(figsize=(12, 6))
        for i, j in enumerate(idx):
            plt.plot(t, arr[:, j], label=labs[i])
        plt.xlabel("Time [s]"); plt.ylabel(ylab); plt.title(title)
        plt.legend(); plt.grid()
        plt.savefig(os.path.join(d_x, f"{stem}_iter_{it}.png"), dpi=100)
        plt.close()

    # orientation panel: MRP -> Euler for the 6-DOF systems, raw theta for
    # the planar piano mover (reference plots.py:188-208)
    plt.figure(figsize=(12, 6))
    if is_mrp:
        eul = mrp_to_euler(X[:, ori])
        for i, lab in enumerate([r"$\phi$", r"$\theta$", r"$\psi$"]):
            plt.plot(t, eul[:, i], label=lab)
    else:
        plt.plot(t, X[:, ori[0]], label=r"$\theta$")
    plt.xlabel("Time [s]"); plt.ylabel("Orientation [rad]")
    plt.title("Orientation Trajectories"); plt.legend(); plt.grid()
    plt.savefig(os.path.join(d_x, f"orientation_iter_{it}.png"), dpi=100)
    plt.close()

    for stem, idx, labs, ylab, title in _CONTROL_PANELS[system]:
        plt.figure(figsize=(12, 6))
        for i, j in enumerate(idx):
            plt.plot(tu, U[:, j], label=labs[i])
        plt.xlabel("Time [s]"); plt.ylabel(ylab); plt.title(title)
        plt.legend(); plt.grid()
        plt.savefig(os.path.join(d_u, f"{stem}_iter_{it}.png"), dpi=100)
        plt.close()


def plot_history(system: str, history, dt: float, every: int = 10):
    """Render trajectory-history snapshots from a list of per-iteration
    (X, U) pairs of one scenario: every ``every``-th iteration plus the
    final one (the
    reference renders at ``iter % 10 == 0`` and at convergence,
    ALTRO.py:424-425,472-474)."""
    n = len(history)
    for i, (X, U) in enumerate(history):
        if i % every == 0 or i == n - 1:
            plot_trajectory_history(system, X, U, dt, i)


def plot_all(system: str, sys_, st, member: int = 0):
    """Render every diagnostic plot from a finished AltroState: scenario
    ``member`` of a batched state."""
    it = int(st.iter[member])
    nb = st.metrics.J.shape[-1]
    n = min(it, nb)
    if it > nb:
        import warnings

        warnings.warn(
            f"metrics buffer truncated ({it} iterations, buffer {nb}): "
            f"history plots cover the first {nb - 1} iterations plus the "
            "final one; raise AltroConfig.metrics_len for the full history")
    m = [to_numpy(a[member])[:n] for a in st.metrics]
    J, _, kmax, _, reg, rho, convio = m
    plot_cost(system, J)
    plot_regularization(system, reg, rho)
    plot_constraint_violation(system, convio, kmax)
    plot_trajectories(system, to_numpy(st.X[member]), to_numpy(st.U[member]),
                      sys_.dt)
