"""Receding-horizon MPC on top of the ALTRO solver, for S scenarios at once.

Port of ``dcol_tpu/solver/mpc.py``.  Per control tick: re-solve the horizon
from the measured state, apply the first control, advance the plant.  Warm
starts carry the full augmented-Lagrangian state across ticks: the shifted
control sequence U, the shifted inequality duals (mu, mux), the goal duals
(lambd) and the penalty rho, so each tick resumes near the previous tick's
optimum.

A true receding horizon is supported through ``xref_path``: a reference
path from which each tick's Xref window is sliced.  Without it the
controller regulates to the fixed ``params["Xref"]``.

The JAX package ``vmap``s a ``lax.scan`` over scenarios; here the ticks are
a Python loop and every tensor carries the scenario dim S.  Each tick is one
lock-step :func:`dcol_tpu_torch.solver.altro.solve` of the S scenarios, in
which a scenario that converges early keeps its state while the others
iterate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.utils.trace import span


class MpcCarry(NamedTuple):
    """The closed loop's full resume state after a tick; pass it back as
    ``resume_from`` to continue a run."""
    x: torch.Tensor       # (S, nx) current plant state
    U: torch.Tensor       # (S, N-1, nu) shifted warm-start controls
    mu: torch.Tensor      # (S, N-1, ncu) shifted control duals
    mux: torch.Tensor     # (S, N, ncx) shifted state duals
    lambd: torch.Tensor   # (S, nx) goal duals
    rho: torch.Tensor     # (S,) AL penalty


class MpcResult(NamedTuple):
    X_applied: torch.Tensor  # (S, n_steps + 1, nx) closed-loop states
    U_applied: torch.Tensor  # (S, n_steps, nu) applied controls
    iters: torch.Tensor      # (S, n_steps) ALTRO iterations per tick
    converged: torch.Tensor  # (S, n_steps) per-tick convergence flag
    cost: torch.Tensor       # (S, n_steps) per-tick solve cost
    convio: torch.Tensor     # (S, n_steps) true constraint violation of the
                             # tick's plan (the solver's convio formula,
                             # |h| + h doubling and goal gap, recomputed from
                             # the final trajectory)
    h_applied: torch.Tensor  # (S, n_steps) max over obstacles of 1 - alpha
                             # at the tick's measured state; > 0 means the
                             # closed loop is in collision
    kmax: torch.Tensor       # (S, n_steps) final feedforward-gain norm
    final: Optional[MpcCarry] = None  # resume state after the last tick


def _shift(a):
    """Drop the leading knot, repeat the last (the warm-start shift along
    the horizon, dim 1)."""
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def _per_scenario(a, S: int, tail: int):
    """(S, ...) as is; an unbatched (...) of ``tail`` dims broadcast to S."""
    return a if a.dim() > tail else a.expand((S,) + tuple(a.shape))


def mpc_run(sys, params, cfg: altro.AltroConfig, x0, U_init, n_steps: int,
            noise: Optional[torch.Tensor] = None,
            xref_path: Optional[torch.Tensor] = None,
            carry_duals: bool = True,
            resume_from: Optional[MpcCarry] = None,
            k0: int = 0) -> MpcResult:
    """Run ``n_steps`` closed-loop ticks of S scenarios.

    params: dict of (S, ...) tensors (as :func:`altro.solve`); x0 (S, nx);
    U_init (S, N-1, nu).
    noise: optional (S, n_steps, nx) or (n_steps, nx) additive state
    disturbance applied after each plant step.
    xref_path: optional (S, T, nx) or (T, nx) reference path with
    T >= k0 + n_steps + N - 1; tick k tracks the window
    ``xref_path[k0 + k : k0 + k + N]``.
    carry_duals: warm-start each tick's AL duals and penalty from the
    previous tick (False: U-only warm start, duals restart at zero).
    resume_from: an :class:`MpcCarry` to continue from (x0 and U_init are
    then ignored); with a windowed ``xref_path`` also pass ``k0``, the
    number of ticks already run."""
    dt, dev = U_init.dtype, U_init.device
    S, nx, N = U_init.shape[0], sys.nx, sys.N

    def zero_duals():
        return (torch.zeros((S, N - 1, sys.ncu), dtype=dt, device=dev),
                torch.zeros((S, N, sys.ncx), dtype=dt, device=dev),
                torch.zeros((S, nx), dtype=dt, device=dev),
                torch.full((S,), cfg.rho0, dtype=dt, device=dev))

    if resume_from is None:
        carry = MpcCarry(x0.to(dt), U_init, *zero_duals())
    else:
        carry = MpcCarry(*(torch.as_tensor(a, dtype=dt, device=dev)
                           for a in resume_from))
    if noise is not None:
        noise = _per_scenario(noise.to(dt), S, 2)
    if xref_path is not None:
        xref_path = _per_scenario(xref_path.to(dt), S, 2)
        if xref_path.shape[1] < k0 + n_steps + N - 1:
            raise ValueError(f"xref_path has {xref_path.shape[1]} knots; "
                             f"ticks {k0}..{k0 + n_steps - 1} need "
                             f"{k0 + n_steps + N - 1}")

    xs, us, outs = [carry.x], [], []
    for k in range(n_steps):
        with span("mpc.tick"):
            x = carry.x
            p = dict(params)
            if xref_path is not None:
                p["Xref"] = xref_path[:, k0 + k:k0 + k + N]
            X0 = x[:, None].expand(S, N, nx)
            if carry_duals:
                st = altro.solve(sys, p, cfg, X0, carry.U,
                                 duals=(carry.mu, carry.mux, carry.lambd),
                                 rho=carry.rho)
            else:
                st = altro.solve(sys, p, cfg, X0, carry.U)
            u0 = st.U[:, 0]
            x_next = sys.discrete_dynamics(p, x, u0)
            if noise is not None:
                x_next = x_next + noise[:, k]
            if carry_duals:
                carry = MpcCarry(x_next, _shift(st.U), _shift(st.mu),
                                 _shift(st.mux), st.lambd, st.rho)
            else:
                carry = MpcCarry(x_next, _shift(st.U), *zero_duals())
            # quality: true violation of the emitted plan (the solver's convio
            # formula) and the collision margin at the measured state
            amax = lambda a: torch.amax(a.reshape(S, -1), dim=1)
            convio = torch.maximum(
                torch.maximum(amax(torch.abs(st.hx + torch.abs(st.hx))),
                              amax(torch.abs(st.hu + torch.abs(st.hu)))),
                amax(torch.abs(st.X[:, -1] - p["Xref"][:, -1])))
            xs.append(x_next)
            us.append(u0)
            outs.append((st.iter, st.converged, st.J, convio,
                         torch.amax(st.hx[:, 0], dim=-1), st.kmax))
    stack = lambda i: torch.stack([o[i] for o in outs], dim=1)
    return MpcResult(torch.stack(xs, dim=1), torch.stack(us, dim=1),
                     *(stack(i) for i in range(6)), final=carry)
