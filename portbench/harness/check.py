"""The comparison that decides ``correct``: the answers the window
produced, judged by the plain reference of their configuration.

A planning answer is a scenario's trajectory (X, U), its constraint
values hx = 1 - alpha at X, its flags and its iteration count, and its
trajectory at the mix's ``progress_iter``; an MPC answer is a tick's
applied control, the plant's next state, the collision margin h at the
measured state and the plan the tick started from and the one it applied.
Numbers compared:

* ``dyn_gap``: the largest gap between a state the program produced and
  the reference's RK4 step from the state and control before it (and
  between a first state and the batch's drawn initial state), over
  1 + |x|;
* ``alpha_gap``: the largest gap between the program's alpha (1 - hx, or
  the margin h) and the reference's, over max(1, alpha), and
  ``alpha_gap_p75`` its 75th percentile over the judged problems.  hx is
  the conic kernel's answer from the window's own launches (the forward
  pass's constraint batch at the accepted trajectory).  The float32 kernel
  stops at mu < tol, a duality gap of up to the cone's degree times tol,
  or at its iteration cap: near contact the program's alpha can lie as
  far from the reference as the control's TF32 rounding puts it, so the
  quantile separates the two where the largest gap does not;
* ``iter_gap`` (planning): the largest difference between a scenario's
  iteration count and the harness's own count of the iterations it was
  active in; exact, limit 0;
* ``goal_gap`` (planning): over scenarios flagged converged, the gap of
  the last state to the goal, held to the configuration's ``convio_tol``;
* ``violation`` (planning): the solver's progress, by the reference: the
  largest constraint violation of a judged trajectory at the mix's
  ``progress_iter``: the deepest overlap 1 - alpha of the robot and an
  obstacle, the final state's gap to the goal, a control beyond its
  bounds (the cold start's is the goal gap, tens of metres);
* ``h_max`` (MPC, printed, not compared): the reference's largest
  collision margin 1 - alpha at the measured states; no fault or control
  raises it, and a capped tick's plan need not be collision-free, so it
  has no upper reading to set a limit below;
* ``plan_goal_gap`` (MPC): the largest gap to the goal of the final state
  of a tick's applied plan, rolled out by the reference from the measured
  state;
* ``stale_ticks`` (MPC): the share of judged ticks that report
  iterations but apply the plan they started from, unchanged.

The control puts the reference in the program's place, computed in the
precision below the configuration's (:data:`socp.CONTROL`): its rollout
of the program's controls, its alpha at the program's states.  It runs no
solver, so the progress numbers (``violation``, ``plan_goal_gap``,
``stale_ticks``) have no control reading: their upper readings come from
the planted faults (:mod:`portbench.harness.faults`)."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.harness import socp, traffic


def _rel(a, b):
    """max |a - b| / (1 + |b|), per row."""
    a, b = a.double(), b.double()
    return ((a - b).abs().amax(-1) / (1.0 + b.abs().amax(-1)))


def _alpha_ref(ref, config, X, ar):
    """alpha (..., n_obs) of the robot at states X."""
    shape = X.shape[:-1]
    Xf = X.reshape(-1, X.shape[-1])
    r, Q = ref.robot_pose(Xf, ar)
    dev = X.device
    obs_r = torch.tensor([o["r"] for o in config["obstacles"]],
                         dtype=ar.dtype, device=dev)
    obs_Q = socp.dcm_from_mrp(torch.tensor([o["p"] for o in
                                            config["obstacles"]],
                                           dtype=torch.float64, device=dev), ar)
    a = socp.alphas(config["robot"], config["obstacles"], r, Q, obs_r, obs_Q,
                    ar)
    return a.reshape(shape + (len(config["obstacles"]),)).double()


def _start(config, mix, seed, batch, rows, device):
    """The drawn initial states of the judged rows of a batch."""
    x0 = torch.as_tensor(config["x0"], dtype=torch.float64, device=device)
    n = traffic.noise(seed, batch, mix["scenarios"], config["nx"],
                      mix["x0_sigma"])[rows]
    return x0 + torch.as_tensor(n, dtype=torch.float64, device=device)


def _rollout(ref, x0, U, ar):
    """States (..., T + 1, nx) from x0 (..., nx) under U (..., T, nu)."""
    xs = [x0.to(ar.dtype)]
    for t in range(U.shape[-2]):
        xs.append(ref.step(xs[-1], U[..., t, :].to(ar.dtype), ar))
    return torch.stack(xs, -2)


def _xref(config, N, device):
    return torch.as_tensor(traffic.reference_path(config, N),
                           dtype=torch.float64, device=device)


def _violation(ref, config, X, U):
    """Each trajectory's largest constraint violation, by the reference:
    the deepest overlap, the final state's gap to the goal, a control
    beyond its bounds."""
    X, U = X.double(), U.double()
    overlap = (1.0 - _alpha_ref(ref, config, X, socp.REF)).clamp(min=0.0)
    goal = (X[..., -1, :] - _xref(config, X.shape[-2], X.device)[-1]).abs()
    bound = torch.maximum(U - config["u_max"], config["u_min"] - U)
    return torch.stack([overlap.amax((-1, -2)), goal.amax(-1),
                        bound.clamp(min=0.0).amax((-1, -2))]).amax(0)


def _progress(ref, config, judged):
    """``violation`` of the judged batches' trajectories at
    ``progress_iter`` (NaN where none got there)."""
    viols = [_violation(ref, config, j["snap"]["X"], j["snap"]["U"])
             for j in judged if j["snap"] is not None]
    return {"violation": float(torch.cat(viols).max()) if viols
            else float("nan")}


def plan_numbers(ref, config, mix, seed, judged, convio_tol,
                 control: bool = False) -> Dict[str, float]:
    """The numbers of a planning window's judged answers (and with
    ``control`` the control's beside them)."""
    R = socp.REF
    out = {"dyn_gap": 0.0, "iter_gap": 0.0, "goal_gap": 0.0, "judged": 0,
           "converged": 0}
    gaps, gaps_c, dyn_c = [], [], 0.0
    for j in judged:
        X, U = j["X"].double(), j["U"].double()
        x0 = _start(config, mix, seed, j["batch"], j["rows"], X.device)
        steps = ref.step(X[:, :-1], U, R)
        dyn = torch.maximum(_rel(X[:, 1:], steps).amax(-1), _rel(X[:, 0], x0))
        a_ref = _alpha_ref(ref, config, X, R)
        a_prog = 1.0 - j["hx"].double()
        gaps.append(((a_prog - a_ref).abs() / a_ref.clamp(min=1.0)).flatten())
        out["dyn_gap"] = max(out["dyn_gap"], float(dyn.max()))
        out["iter_gap"] = max(out["iter_gap"], float(
            (j["iter"].long() - j["count"].long()).abs().max()))
        conv = j["converged"]
        if bool(conv.any()):
            goal = traffic.reference_path(config, config["N"])[-1]
            goal = torch.as_tensor(goal, dtype=torch.float64, device=X.device)
            v = (X[:, -1] - goal).abs().amax(-1)
            out["goal_gap"] = max(out["goal_gap"], float(v[conv].max()))
        out["judged"] += X.shape[0]
        out["converged"] += int(conv.sum())
        if control:
            C = socp.CONTROL
            xs = [x0.to(C.dtype)]
            for t in range(U.shape[1]):
                xs.append(ref.step(xs[-1], U[:, t].to(C.dtype), C))
            Xc = torch.stack(xs, 1).double()
            dc = _rel(Xc[:, 1:], ref.step(Xc[:, :-1], U, R)).amax(-1)
            dyn_c = max(dyn_c, float(dc.max()))
            ac = _alpha_ref(ref, config, X, C)
            gaps_c.append(((ac - a_ref).abs() / a_ref.clamp(min=1.0))
                          .flatten())
    out.update(_alpha_numbers(torch.cat(gaps)))
    out.update(_progress(ref, config, judged))
    if control:
        out["dyn_gap_control"] = dyn_c
        out.update({k + "_control": v for k, v in
                    _alpha_numbers(torch.cat(gaps_c)).items()})
    return out


def _alpha_numbers(g) -> Dict[str, float]:
    """The largest and the 75th-percentile alpha gap."""
    g = g.double()
    g = torch.where(torch.isfinite(g), g, torch.full_like(g, float("inf")))
    return {"alpha_gap": float(g.max()),
            "alpha_gap_p75": float(torch.quantile(g.cpu(), 0.75))}


def mpc_numbers(ref, config, mix, seed, rows, judged,
                control: bool = False) -> Dict[str, float]:
    """The numbers of an MPC window's judged ticks."""
    R = socp.REF
    x = torch.stack([j["x"] for j in judged], 1).double()        # (s, K, nx)
    u = torch.stack([j["u"] for j in judged], 1).double()
    xn = torch.stack([j["x_next"] for j in judged], 1).double()
    h = torch.stack([j["h"] for j in judged], 1).double()
    iters = torch.stack([j["iters"] for j in judged], 1)
    x0 = _start(config, mix, seed, 0, rows, x.device)
    dyn = torch.maximum(_rel(xn, ref.step(x, u, R)).amax(-1),
                        _rel(x[:, 0], x0))
    a_ref = _alpha_ref(ref, config, x, R)
    h_ref = (1.0 - a_ref).amax(-1)
    scale = a_ref.amin(-1).clamp(min=1.0)
    # each tick's applied plan: its first control, then the carry's
    # shifted rest; rolled out from the measured state
    U_next = torch.stack([j["U_next"] for j in judged], 1).double()
    U_start = torch.stack([j["U_start"] for j in judged], 1).double()
    plan = torch.cat([u[:, :, None], U_next[:, :, :-1]], 2)
    goal = _xref(config, mix["horizon"], x.device)[-1]
    end = _rollout(ref, x, plan, R)[..., -1, :]
    stale = (iters >= 1) & (plan == U_start).flatten(2).all(-1)
    out = {"dyn_gap": float(dyn.max()),
           **_alpha_numbers(((h - h_ref).abs() / scale).flatten()),
           "h_max": float(h_ref.max()),
           "plan_goal_gap": float((end - goal).abs().amax(-1).max()),
           "stale_ticks": float(stale.double().mean()),
           "iters_over_cap": float((iters.long() - mix["tick_iters"])
                                   .clamp(min=0).max()),
           "judged": int(x.shape[0] * x.shape[1])}
    if control:
        C = socp.CONTROL
        xc = ref.step(x.to(C.dtype), u.to(C.dtype), C).double()
        out["dyn_gap_control"] = float(_rel(xc, ref.step(x, u, R)).max())
        ac = _alpha_ref(ref, config, x, C)
        hc = (1.0 - ac).amax(-1)
        out.update({k + "_control": v for k, v in _alpha_numbers(
            ((hc - h_ref).abs() / scale).flatten()).items()})
    return out


def limits_of(cell_limits: dict, convio_tol: float) -> Dict[str, float]:
    """Every compared number's limit: the cell's limits file, and
    ``goal_gap``'s, the configuration's convergence tolerance."""
    out = dict(cell_limits["limits"])
    if "iter_gap" in out:
        out["goal_gap"] = convio_tol
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) of the compared numbers."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
