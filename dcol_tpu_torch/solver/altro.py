"""AL-iLQR (ALTRO-style) trajectory optimiser on torch tensors.

Port of ``dcol_tpu/solver/altro.py``: the augmented-Lagrangian outer loop
{Riccati backward pass, line-searched forward pass, regularisation update,
dual/penalty update} with the same masks, recurrences, tolerances and update
rules.  The JAX package ``vmap``s a ``while_loop`` over scenarios; here every
tensor carries an explicit leading scenario dim S and the loops are Python
loops over masks:

  * per-scenario state lives in :class:`AltroState` with shape (S, ...);
  * the outer loop runs while any scenario is active; inactive scenarios
    keep their state (selection by mask) and cost no PDIP work (their solver
    lanes are skipped);
  * the Riccati recursion is a Python loop over knots, batched over
    scenarios; so are the rollouts (over scenarios and line-search
    candidates), except on the card for a system that names a rollout
    kernel (the quadrotor), where each is one launch;
  * the dynamics Jacobians and envelope gradients are forward-mode
    (``torch.func.jvp``) with the tangent directions as a leading batch dim;
    a system built with ``fd_jacobians=True`` takes the reference's forward
    differences instead, the perturbations as the same leading dim.

Convergence criteria match the reference: feedforward-gain norm
``kmax < atol`` gates the dual update; ``convio < convio_tol`` (with the
reference's ``|h| + h`` doubling for inequalities) declares convergence.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from dcol_tpu_torch.ops import chol, rollout_cuda
from dcol_tpu_torch.systems.base import jvp, scenario_view
from dcol_tpu_torch.utils import trace
from dcol_tpu_torch.utils.trace import span

# forward-difference step of the reference's dynamics Jacobians
# (ALTRO.py:77-100), taken when a system is built with fd_jacobians=True
FD_DELTA = 1e-6


@dataclasses.dataclass(frozen=True)
class AltroConfig:
    max_iters: int = 3000
    max_ls_iters: int = 20
    atol: float = 1e-2
    convio_tol: float = 1e-4
    rho0: float = 1.0
    phi: float = 10.0
    reg_min: float = 1e-6
    reg_max: float = 1e2
    # Ring-buffer length for per-iteration metrics; iterations past it all
    # write the last slot.
    metrics_len: int = 256
    # line-search acceptance slack relative to (1 + |old_cost|): 0 is the
    # reference's strict decrease; f32 + warm-started PDIP needs a little
    ls_slack: float = 0.0
    # f32 only: perform the dual/penalty update when the inner minimisation
    # has converged (kmax < atol) even if the line search could not certify
    # a decrease (rounding at an AL plateau).  Never applied in f64.
    dual_on_stall: bool = True
    # Line-search candidates per batched evaluation after the alpha = 1
    # probe.  The candidates are the backtracking sequence {1, 1/2, ...} and
    # the largest acceptable one wins, so the accepted alpha is identical to
    # sequential backtracking for any value.
    ls_parallel: int = 4


class Metrics(NamedTuple):
    J: torch.Tensor         # each (S, metrics_len)
    delta_J: torch.Tensor
    kmax: torch.Tensor
    alpha: torch.Tensor
    reg: torch.Tensor
    rho: torch.Tensor
    convio: torch.Tensor


class AltroState(NamedTuple):
    X: torch.Tensor         # (S, N, nx)
    U: torch.Tensor         # (S, N-1, nu)
    mu: torch.Tensor        # (S, N-1, ncu) control-constraint duals
    mux: torch.Tensor       # (S, N, ncx) state-constraint duals
    lambd: torch.Tensor     # (S, nx) goal-constraint duals
    rho: torch.Tensor       # (S,) AL penalty
    reg: torch.Tensor       # (S,) Riccati regularisation
    hx: torch.Tensor        # (S, N, ncx) cached constraint values at X
    hu: torch.Tensor        # (S, N-1, ncu) cached control-constraint values
    warm: tuple             # per obstacle group (x, s, z), (S, N*n_g, .):
                            # INVARIANT: the converged PDIP solution at the
                            # CURRENT X
    iter: torch.Tensor      # (S,) int32
    converged: torch.Tensor  # (S,) bool
    failed: torch.Tensor    # (S,) bool
    J: torch.Tensor         # (S,)
    delta_J: torch.Tensor
    kmax: torch.Tensor
    alpha: torch.Tensor
    convio: torch.Tensor
    metrics: Metrics


def tree_map(fn, *trees):
    """``fn`` over the tensors of (named) tuples and dicts of one structure,
    such as an :class:`AltroState` with its per-group ``warm`` tuple."""
    a = trees[0]
    if isinstance(a, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in a}
    if isinstance(a, tuple):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(a)(*out) if hasattr(a, "_fields") else tuple(out)
    return fn(*trees)


def _where(pred, a, b):
    """Per-scenario select over tensors / (named) tuples; pred is (S,)."""
    return tree_map(lambda x, y: torch.where(
        pred.reshape(pred.shape + (1,) * (x.dim() - 1)), x, y), a, b)


def _mv(A, v):
    """A @ v with A (S, n, k) or (S, ..., n, k) and v (S, ..., k)."""
    return (scenario_view(A, v.dim() + 1) @ v[..., None])[..., 0]


def _mtv(A, v):
    """A' v: A (..., k, n), v (..., k) -> (..., n)."""
    return (v[..., None, :] @ A)[..., 0, :]


def _mtm(A, B):
    """A' B: A (..., k, n), B (..., k, m) -> (..., n, m)."""
    return A.transpose(-1, -2) @ B


def eval_mask(mu, h):
    """AL active mask: active iff the dual is positive or the constraint is
    violated (ALTRO.py:16-31)."""
    return ((scenario_view(mu, h.dim()) > 0) | (h > 0)).to(h.dtype)


# ---------------------------------------------------------------------------
# Cost (reduces the last two dims: X (S, ..., N, nx) -> (S, ...))
# ---------------------------------------------------------------------------

def _sum_knots(a):
    """Each scenario's sum over the last two dims (knots, components), one
    short dim at a time: on the card a reduction over a long contiguous row
    groups its elements by the row's address, so identical scenarios in
    different rows of the batch would round differently."""
    return a.sum(-1).sum(-1)


def quad_cost(sys, params, X, U):
    """Sum of LQR tracking terms (running + terminal), ALTRO.py:148-180."""
    dX = X - scenario_view(params["Xref"], X.dim())
    dU = U - scenario_view(params["Uref"], U.dim())
    run_x = 0.5 * _sum_knots(dX[..., :-1, :] * _mv(params["Q"],
                                                   dX[..., :-1, :]))
    run_u = 0.5 * _sum_knots(dU * _mv(params["R"], dU))
    term = 0.5 * torch.sum(dX[..., -1, :] * _mv(params["Qf"], dX[..., -1, :]),
                           dim=-1)
    return run_x + run_u + term


def al_cost(params, X, hx, hu, mu, mux, lambd, rho):
    """Augmented-Lagrangian penalty terms (ALTRO.py:120-144)."""
    r = scenario_view(rho, X.dim() - 2)
    mask_u = eval_mask(mu, hu)
    c_u = (_sum_knots(scenario_view(mu, hu.dim()) * hu)
           + 0.5 * r * _sum_knots(mask_u * hu * hu))
    mask_x = eval_mask(mux, hx)
    c_x = (_sum_knots(scenario_view(mux, hx.dim()) * hx)
           + 0.5 * r * _sum_knots(mask_x * hx * hx))
    dxN = X[..., -1, :] - scenario_view(params["Xref"][:, -1], X.dim() - 1)
    c_g = (torch.sum(scenario_view(lambd, dxN.dim()) * dxN, dim=-1)
           + 0.5 * r * torch.sum(dxN * dxN, dim=-1))
    return c_u + c_x + c_g


def total_cost(sys, params, X, U, hx, hu, mu, mux, lambd, rho):
    return quad_cost(sys, params, X, U) + al_cost(
        params, X, hx, hu, mu, mux, lambd, rho)


def eval_constraints(sys, params, X, U, warm=None):
    """(hx (S, N, ncx), hu (S, N-1, ncu), warm); the hx batch is one PDIP
    solve per obstacle group, warm-started when ``warm`` is given."""
    hx, new_warm = sys.constraints_x_traj(params, X, warm=warm)
    return hx, sys.constraints_u(params, U), new_warm


# ---------------------------------------------------------------------------
# Backward pass (Riccati recursion with AL terms), ALTRO.py:242-338
# ---------------------------------------------------------------------------

def dynamics_jacobians(sys, params, X, U):
    """A (S, T, nx, nx), B (S, T, nx, nu) of the discrete dynamics at
    X (S, T, nx), U (S, T, nu).  Exact: one forward-mode pass with the
    nx + nu tangent directions as a leading batch dim.  With
    ``sys.fd_jacobians`` the reference's forward differences instead
    (ALTRO.py:77-100): column i is (f(x + d e_i, u) - f(x, u)) / d with
    d = ``FD_DELTA``, and B's likewise over u, with the unperturbed step and
    the nx + nu perturbed ones as one leading batch dim through one
    ``discrete_dynamics`` call."""
    nx, nu = sys.nx, sys.nu
    n = nx + nu
    E = torch.eye(n, dtype=X.dtype, device=X.device)
    if sys.fd_jacobians:
        d = torch.as_tensor(FD_DELTA, dtype=X.dtype, device=X.device)
        step = torch.cat([torch.zeros_like(E[:1]), d * E])[:, None, None]
        f = sys.discrete_dynamics(params, X + step[..., :nx],
                                  U + step[..., nx:])
        diff = ((f[1:] - f[0]) / d).permute(1, 2, 3, 0)  # (S, T, nx, n)
        return diff[..., :nx], diff[..., nx:]
    # jvp needs dense (not expanded) primals and tangents
    nX, nU = (n,) + X.shape, (n,) + U.shape
    tx = E[:, None, None, :nx].expand(nX).contiguous()
    tu = E[:, None, None, nx:].expand(nU).contiguous()
    _, d = jvp(lambda x, u: sys.discrete_dynamics(params, x, u),
               (X.expand(nX).contiguous(), U.expand(nU).contiguous()),
               (tx, tu))
    d = d.permute(1, 2, 3, 0)  # (S, T, nx_out, n_in)
    return d[..., :nx], d[..., nx:]


def backward_pass(sys, params, X, U, mu, mux, lambd, rho, reg, warm=None,
                  skip=None):
    """(K (S, N-1, nu, nx), k (S, N-1, nu), delta_J (S,), kmax (S,)).
    ``skip``: (S,) bool, scenarios whose output the caller discards; their
    polish PDIP lanes run zero iterations."""
    N, nx = sys.N, sys.nx
    dt, dev = X.dtype, X.device
    Q, R, Qf = params["Q"], params["R"], params["Qf"]
    with span("altro.backward.jacobians"):
        A, B = dynamics_jacobians(sys, params, X[:, :-1], U)

    # constraint values + envelope gradients at X: one PDIP batch per group,
    # warm-started from the accepted candidate's solution at this exact X
    with span("altro.backward.polish"):
        hx, gx, _ = sys.constraints_x_vg_traj(params, X, warm=warm,
                                              skip=skip)
    hu = sys.constraints_u(params, U)
    gu = sys.constraints_u_grad(dt, dev)               # (ncu, nu)
    mask_x = eval_mask(mux, hx)                        # (S, N, ncx)
    mask_u = eval_mask(mu, hu)                         # (S, N-1, ncu)
    r3, r4 = scenario_view(rho, 3), scenario_view(rho, 4)

    dX = X - params["Xref"]
    wx = mux[:, :-1] + r3 * mask_x[:, :-1] * hx[:, :-1]
    l_x = _mv(Q, dX[:, :-1]) + torch.sum(gx[:, :-1] * wx[..., None], dim=-2)
    l_xx = Q[:, None] + r4 * _mtm(gx[:, :-1] * mask_x[:, :-1, :, None],
                                  gx[:, :-1])
    dU = U - params["Uref"]
    wu = mu + r3 * mask_u * hu
    l_u = _mv(R, dU) + torch.sum(gu * wu[..., None], dim=-2)
    l_uu = R[:, None] + r4 * _mtm(gu * mask_u[..., None], gu)

    with span("altro.backward.riccati"):
        # terminal value function incl. AL state + goal terms
        # (ALTRO.py:267-287)
        r1, r2 = scenario_view(rho, 2), scenario_view(rho, 3)
        I_nx = torch.eye(nx, dtype=dt, device=dev)
        Vx = (_mv(Qf, dX[:, -1])
              + _mtv(gx[:, -1], mux[:, -1] + r1 * mask_x[:, -1] * hx[:, -1])
              + lambd + r1 * dX[:, -1])
        Vxx = (Qf + r2 * _mtm(gx[:, -1] * mask_x[:, -1][..., None],
                              gx[:, -1])
               + r2 * I_nx)

        reg_I = scenario_view(reg, 3) * I_nx
        dJ = torch.zeros_like(rho)
        Ks, ks = [None] * (N - 1), [None] * (N - 1)
        for t in reversed(range(N - 1)):
            A_t, B_t = A[:, t], B[:, t]
            lu_t, luu_t = l_u[:, t], l_uu[:, t]
            Vxx_r = Vxx + reg_I
            VA = Vxx_r @ A_t
            VB = Vxx_r @ B_t
            Qu = lu_t + _mtv(B_t, Vx)
            Quu = luu_t + _mtm(B_t, VB)
            Qux = _mtm(B_t, VA)
            L = chol.chol_factor(Quu)
            k_t = chol.chol_solve(L, Qu)
            K_t = chol.chol_solve(L[:, None],
                                  Qux.transpose(-1, -2)).transpose(-1, -2)
            Abar = A_t - B_t @ K_t
            Vxx_new = (l_xx[:, t] + _mtm(K_t, luu_t @ K_t)
                       + _mtm(Abar, Vxx @ Abar))
            Bk = (B_t @ k_t[..., None])[..., 0]
            Vx = (l_x[:, t] - _mtv(K_t, lu_t)
                  + _mtv(K_t, (luu_t @ k_t[..., None])[..., 0])
                  + _mtv(Abar, Vx - (Vxx @ Bk[..., None])[..., 0]))
            Vxx = Vxx_new
            dJ = dJ + torch.sum(Qu * k_t, dim=-1)
            Ks[t], ks[t] = K_t, k_t
        K = torch.stack(Ks, dim=1)
        k = torch.stack(ks, dim=1)
        kmax = torch.amax(torch.linalg.vector_norm(k, dim=-1), dim=-1)
    return K, k, dJ, kmax


# ---------------------------------------------------------------------------
# Forward pass (backtracking line search), ALTRO.py:183-239
# ---------------------------------------------------------------------------

def uses_rollout_kernel(sys, t) -> bool:
    """Whether a rollout of ``sys`` over tensor ``t`` runs as one kernel
    launch (:mod:`dcol_tpu_torch.ops.rollout_cuda`): a CUDA tensor of a
    system that names a rollout kernel.  Every other rollout runs the
    loop."""
    return t.is_cuda and sys.rollout_kernel is not None


def _note_rollout(path: str) -> None:
    if trace.recording():
        trace.RECORDER.rollouts[path] += 1


def rollout(sys, params, X, U, K, k, alpha):
    """Closed-loop rollouts for per-scenario candidate step sizes
    alpha (S, C): returns Xn (S, C, N, nx), Un (S, C, N-1, nu).  One
    kernel launch on the card for a system that names a rollout kernel
    (which raises if it cannot run), else :func:`rollout_loop`."""
    with span("altro.rollout"):
        if uses_rollout_kernel(sys, X):
            _note_rollout("kernel")
            return rollout_cuda.rollout_cuda(sys, X, U, K, k, alpha)
        _note_rollout("loop")
        return rollout_loop(sys, params, X, U, K, k, alpha)


def rollout_loop(sys, params, X, U, K, k, alpha):
    """The plain version of :func:`rollout`: a Python loop over knots."""
    x = X[:, None, 0].expand(alpha.shape + X.shape[-1:])
    a = alpha[..., None]
    xs, us = [x], []
    for t in range(sys.N - 1):
        u = (U[:, None, t]
             - (K[:, None, t] @ (x - X[:, None, t])[..., None])[..., 0]
             - a * k[:, None, t])
        x = sys.discrete_dynamics(params, x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=2), torch.stack(us, dim=2)


def initial_rollout(sys, params, x0, U):
    """Open-loop rollout from x0 (S, nx) under U (S, N-1, nu): one kernel
    launch where :func:`rollout` takes one, else
    :func:`initial_rollout_loop`."""
    if uses_rollout_kernel(sys, x0):
        _note_rollout("kernel")
        return rollout_cuda.initial_rollout_cuda(sys, x0, U)
    _note_rollout("loop")
    return initial_rollout_loop(sys, params, x0, U)


def initial_rollout_loop(sys, params, x0, U):
    """The plain version of :func:`initial_rollout`."""
    xs = [x0]
    for t in range(sys.N - 1):
        xs.append(sys.discrete_dynamics(params, xs[-1], U[:, t]))
    return torch.stack(xs, dim=1)


def _take(a, idx):
    """a[s, idx[s]] for every scenario s."""
    return a[torch.arange(a.shape[0], device=a.device), idx]


def forward_pass(sys, params, cfg, X, U, K, k, mu, mux, lambd, rho, hx, hu,
                 warm, active=None):
    """Backtracking line search with chunked candidate evaluation.

    The reference halves alpha until the cost decreases.  Here the alpha = 1
    probe runs first; scenarios that reject it evaluate chunks of
    ``ls_parallel`` further candidates, each chunk one batched rollout + one
    PDIP batch per obstacle group, and the largest acceptable candidate wins
    (identical to the sequential algorithm's choice).

    ``active``: (S,) bool.  Inactive scenarios probe alpha = 0 with their
    PDIP lanes skipped and count as found, so they never force a chunk.  A
    scenario that has found its step rides along the remaining chunks with
    its accepted alpha, its accepted solution as warm start and its PDIP
    lanes skipped; its results are discarded."""
    S = X.shape[0]
    dt, dev = X.dtype, X.device
    old_cost = total_cost(sys, params, X, U, hx, hu, mu, mux, lambd, rho)
    thresh = old_cost + cfg.ls_slack * (1.0 + torch.abs(old_cost))
    L = cfg.max_ls_iters
    C = max(1, min(cfg.ls_parallel, max(1, L - 1)))
    n_chunks = -(-(L - 1) // C) if L > 1 else 0
    n_all = 1 + n_chunks * C
    alphas_all = (0.5 ** torch.arange(n_all, device=dev)).to(dt)
    valid_all = torch.arange(n_all, device=dev) < L

    def eval_candidates(a_c, valid_c, w, skip=None):
        """One batched evaluation of candidate alphas a_c (S, C): the C
        rollouts of every scenario are flattened into one PDIP batch."""
        Cc = a_c.shape[1]
        N = sys.N
        Xn, Un = rollout(sys, params, X, U, K, k, a_c)
        w_t = tuple(tuple(a.repeat(1, Cc, 1) for a in g) for g in w)
        hxf, wf = sys.constraints_x_traj(params, Xn.reshape(S, Cc * N, sys.nx),
                                         warm=w_t, skip=skip)
        hxn = hxf.reshape(S, Cc, N, -1)
        wn = tuple(tuple(a.reshape(S, Cc, -1, a.shape[-1]) for a in g)
                   for g in wf)
        hun = sys.constraints_u(params, Un)
        Jn = total_cost(sys, params, Xn, Un, hxn, hun, mu, mux, lambd, rho)
        ok = valid_c[None, :] & (Jn < thresh[:, None])
        idx = torch.argmax(ok.to(torch.int8), dim=1)  # first = largest alpha
        cand = (_take(Xn, idx), _take(Un, idx), _take(hxn, idx),
                _take(hun, idx), _take(Jn, idx), _take(a_c, idx),
                tuple(tuple(_take(a, idx) for a in g) for g in wn))
        w_last = tuple(tuple(a[:, -1] for a in g) for g in wn)
        return ok.any(dim=1), cand, w_last

    sel = (X, U, hx, hu, old_cost, torch.zeros_like(old_cost), warm)

    # phase 1: the full step alpha = 1 alone
    with span("altro.forward.probe"):
        a1 = alphas_all[:1].expand(S, 1)
        skip1 = None
        if active is not None:
            a1 = torch.where(active[:, None], a1, torch.zeros_like(a1))
            skip1 = ~active
        ok1, cand1, w = eval_candidates(a1, valid_all[:1], warm, skip=skip1)
        sel = _where(ok1, cand1, sel)
        found = ok1 if active is None else (ok1 | ~active)

    # phase 2: chunks of C candidates {1/2, 1/4, ...} while any scenario
    # still searches
    for ci in range(n_chunks):
        with span("altro.forward.chunk"):
            if bool(found.all()):
                break
            lo = 1 + ci * C
            a_c = alphas_all[lo:lo + C].expand(S, C)
            a_c = torch.where(found[:, None], sel[5][:, None], a_c)
            w_in = _where(found, sel[6], w)
            any_ok, cand, w = eval_candidates(a_c, valid_all[lo:lo + C],
                                              w_in, skip=found)
            sel = _where(any_ok & ~found, cand, sel)
            found = found | any_ok
    # on total failure the fallback (alpha = 0, unchanged trajectories)
    # keeps the INCOMING warm: the converged solution at the unchanged X
    return sel


# ---------------------------------------------------------------------------
# Outer AL iteration
# ---------------------------------------------------------------------------

def make_initial_state(sys, params, cfg, X0, U0, duals=None,
                       rho=None) -> AltroState:
    """Initial solver state: rollout from X0[:, 0] under U0.

    ``duals`` = (mu (S, N-1, ncu), mux (S, N, ncx), lambd (S, nx)) and
    ``rho`` ((S,) or a scalar) optionally seed the augmented-Lagrangian
    state from a previous nearby solve (MPC warm starts across ticks); the
    defaults are the reference's cold start, zero duals and ``cfg.rho0``
    (ALTRO.py:396-403)."""
    with span("altro.initial_state"):
        S = X0.shape[0]
        dt, dev = U0.dtype, U0.device
        X = initial_rollout(sys, params, X0[:, 0].to(dt), U0)
        hx, hu, warm = eval_constraints(sys, params, X, U0)
        if duals is None:
            mu = torch.zeros((S, sys.N - 1, sys.ncu), dtype=dt, device=dev)
            mux = torch.zeros((S, sys.N, sys.ncx), dtype=dt, device=dev)
            lambd = torch.zeros((S, sys.nx), dtype=dt, device=dev)
        else:
            mu, mux, lambd = (torch.as_tensor(d, dtype=dt, device=dev)
                              for d in duals)
            want = ((S, sys.N - 1, sys.ncu), (S, sys.N, sys.ncx), (S, sys.nx))
            got = (tuple(mu.shape), tuple(mux.shape), tuple(lambd.shape))
            if got != want:
                raise ValueError(f"duals (mu, mux, lambd) have shapes {got}, "
                                 f"expected {want}")
        if rho is None:
            rho0 = torch.full((S,), cfg.rho0, dtype=dt, device=dev)
        else:
            rho0 = torch.as_tensor(rho, dtype=dt, device=dev).expand(S).clone()
        J0 = total_cost(sys, params, X, U0, hx, hu, mu, mux, lambd, rho0)
        z = torch.zeros((S,), dtype=dt, device=dev)
        m = Metrics(*(torch.zeros((S, cfg.metrics_len), dtype=dt, device=dev)
                      for _ in range(7)))
        return AltroState(
            X=X, U=U0, mu=mu, mux=mux, lambd=lambd, rho=rho0,
            reg=torch.full((S,), cfg.reg_min, dtype=dt, device=dev),
            hx=hx, hu=hu, warm=warm,
            iter=torch.zeros((S,), dtype=torch.int32, device=dev),
            converged=torch.zeros((S,), dtype=torch.bool, device=dev),
            failed=torch.zeros((S,), dtype=torch.bool, device=dev),
            J=J0, delta_J=z, kmax=z, alpha=z, convio=z, metrics=m)


def altro_iteration(sys, params, cfg, st: AltroState,
                    active: Optional[torch.Tensor] = None) -> AltroState:
    """One AL iteration for every scenario.  ``active`` (S,) marks scenarios
    still being solved; inactive ones skip PDIP work whose results the
    caller discards (see forward_pass)."""
    dt = st.X.dtype
    K, k, delta_J, kmax = backward_pass(
        sys, params, st.X, st.U, st.mu, st.mux, st.lambd, st.rho, st.reg,
        warm=st.warm, skip=None if active is None else ~active)
    X, U, hx, hu, J, alpha, warm = forward_pass(
        sys, params, cfg, st.X, st.U, K, k, st.mu, st.mux, st.lambd, st.rho,
        st.hx, st.hu, st.warm, active=active)

    with span("altro.duals"):
        # regularisation update (ALTRO.py:51-74); at-cap failure sets a flag
        failed = st.failed | ((alpha == 0.0) & (st.reg >= cfg.reg_max))
        reg = torch.where(
            alpha == 0.0, torch.clamp(st.reg * 10.0, max=cfg.reg_max),
            torch.where(alpha == 1.0,
                        torch.clamp(st.reg / 10.0, min=cfg.reg_min), st.reg))

        # dual + penalty update, gated on (alpha > 0) & (kmax < atol)
        # (ALTRO.py:444-481); the stall relaxation applies only below f64
        dual_on_stall = cfg.dual_on_stall and dt != torch.float64
        do_dual = (kmax < cfg.atol) & ((alpha > 0.0) | dual_on_stall)
        r3 = scenario_view(st.rho, 3)
        mask_u = eval_mask(st.mu, hu)
        mu_new = torch.clamp(st.mu + r3 * mask_u * hu, min=0.0)
        convio_u = torch.amax(torch.abs(hu + torch.abs(hu)), dim=(-2, -1))
        mask_x = eval_mask(st.mux, hx)
        mux_new = torch.clamp(st.mux + r3 * mask_x * hx, min=0.0)
        convio_x = torch.amax(torch.abs(hx + torch.abs(hx)), dim=(-2, -1))
        dxN = X[:, -1] - params["Xref"][:, -1]
        lambd_new = st.lambd + st.rho[:, None] * dxN
        convio = torch.maximum(torch.maximum(convio_u, convio_x),
                               torch.amax(torch.abs(dxN), dim=-1))
        converged = do_dual & (convio < cfg.convio_tol)
        rho = torch.where(do_dual & ~converged, st.rho * cfg.phi, st.rho)
        mu = _where(do_dual, mu_new, st.mu)
        mux = _where(do_dual, mux_new, st.mux)
        lambd = _where(do_dual, lambd_new, st.lambd)
        convio_out = torch.where(do_dual, convio, st.convio)

        slot = torch.clamp(st.iter, max=cfg.metrics_len - 1).long()[:, None]
        put = lambda buf, v: buf.scatter(1, slot, v[:, None].to(buf.dtype))
        m = st.metrics
        m = Metrics(J=put(m.J, J), delta_J=put(m.delta_J, delta_J),
                    kmax=put(m.kmax, kmax), alpha=put(m.alpha, alpha),
                    reg=put(m.reg, reg), rho=put(m.rho, rho),
                    convio=put(m.convio, convio_out))
    return AltroState(
        X=X, U=U, mu=mu, mux=mux, lambd=lambd, rho=rho, reg=reg,
        hx=hx, hu=hu, warm=warm, iter=st.iter + 1, converged=converged,
        failed=failed, J=J, delta_J=delta_J, kmax=kmax, alpha=alpha,
        convio=convio_out, metrics=m)


def solve(sys, params, cfg: AltroConfig, X0, U0, duals=None,
          rho=None) -> AltroState:
    """Full solves of S scenarios: initial rollout, then AL iterations while
    any scenario is active.  Converged, failed or capped scenarios keep
    their state.  ``duals``/``rho`` warm-start the AL state (see
    :func:`make_initial_state`)."""
    st = make_initial_state(sys, params, cfg, X0, U0, duals=duals, rho=rho)
    return iterate(sys, params, cfg, st)


def iterate(sys, params, cfg: AltroConfig, st: AltroState,
            callback=None) -> AltroState:
    """AL iterations from ``st`` while any scenario is active (not
    converged, not failed, under ``cfg.max_iters``); the others keep their
    state.  ``callback(itr, st)`` runs after every iteration with the
    batched state, ``itr`` counting this call's iterations from 0.  The one
    loop of :func:`solve`, :func:`solve_verbose` and a resume from a
    checkpoint (:mod:`dcol_tpu_torch.parallel.checkpoint`)."""
    itr = 0
    while True:
        with span("altro.iteration"):
            active = ~(st.converged | st.failed) & (st.iter < cfg.max_iters)
            if not bool(active.any()):
                return st
            st = _where(active, altro_iteration(sys, params, cfg, st,
                                                active=active), st)
        if callback is not None:
            callback(itr, st)
        itr += 1


TABLE_HEADER = ("iter     J           dJ        |d|         a        reg"
                "         rho\n" + "-" * 69)


def table_row(i: int, J, dJ, kmax, alpha, reg, rho) -> str:
    """Row ``i`` (from 1) of the reference's iteration table."""
    return (f"{i:3d}   {J:10.3e}  {dJ:9.2e}  {kmax:9.2e}  {alpha:6.4f}"
            f"   {reg:9.2e}   {rho:9.2e}")


def solve_verbose(sys, params, cfg: AltroConfig, X0, U0, callback=None,
                  print_table: bool = True) -> AltroState:
    """:func:`solve` that prints scenario 0's row of the reference's
    iteration table (ALTRO.py:437-440) after each of its iterations, at one
    host sync a row.  ``callback(itr, st)`` runs after every AL iteration
    with the batched state, e.g. to keep the X/U history the reference
    plots (ALTRO.py:402-403,419-420).  Stops when every scenario is
    converged, failed or capped."""
    def step(itr, st):
        # scenario 0 ran iteration itr iff its count moved to itr + 1
        if print_table and int(st.iter[0]) == itr + 1:
            if itr % 50 == 0:
                print(TABLE_HEADER)
            print(table_row(itr + 1, *torch.stack(
                [st.J, st.delta_J, st.kmax, st.alpha, st.reg, st.rho]
            )[:, 0].tolist()))
            if bool(st.converged[0]):
                print(f"Convergence reached in {itr + 1} iterations.")
            elif bool(st.failed[0]):
                print("Solve failed (regularization cap reached).")
        if callback is not None:
            callback(itr, st)

    st = make_initial_state(sys, params, cfg, X0, U0)
    return iterate(sys, params, cfg, st, callback=step)
