"""Faults planted in the timed path underneath the harness, each of which
a run has to come out not correct under: the readings of a fault set the
upper end of the limits that no control reading separates.

* ``unchanged``: an ALTRO iteration that returns its state unchanged;
* ``frozen``: an iteration that advances its count but leaves the
  trajectories (and the constraint values at them) as they were;
* ``no_dual``: the dual and penalty update never applied, so that no
  scenario converges;
* ``half_batch``: half of each conic batch left out, the rest given the
  mean of the half solved;
* ``altered``: an answer altered where it is produced (one state of every
  trajectory moved by 1e-3)."""

from __future__ import annotations

import contextlib

import torch


def _unchanged(altro, base):
    altro.altro_iteration = lambda sys, params, cfg, st, active=None: st


def _frozen(altro, base):
    step = altro.altro_iteration

    def frozen(sys, params, cfg, st, active=None):
        new = step(sys, params, cfg, st, active=active)
        return new._replace(X=st.X, U=st.U, hx=st.hx, hu=st.hu, warm=st.warm)
    altro.altro_iteration = frozen


def _no_dual(altro, base):
    step = altro.altro_iteration

    def no_dual(sys, params, cfg, st, active=None):
        new = step(sys, params, cfg, st, active=active)
        return new._replace(mu=st.mu, mux=st.mux, lambd=st.lambd, rho=st.rho,
                            converged=st.converged)
    altro.altro_iteration = no_dual


def _half_batch(altro, base):
    def halved(solve):
        def half(c, G, h, lay, warm=None, skip=None, **kw):
            B = c.shape[0]
            k = max(1, B // 2)
            w = None if warm is None else tuple(a[:k] for a in warm)
            sk = None if skip is None else skip[:k]
            sol = solve(c[:k], G[:k], h[:k], lay, warm=w, skip=sk, **kw)
            mean = lambda a: torch.cat([a, a.mean(0, keepdim=True).expand(
                (B - k,) + a.shape[1:]).to(a.dtype)])
            return type(sol)(*(mean(a.double()).to(a.dtype) for a in sol))
        return half
    base.solve_socp = halved(base.solve_socp)
    base.solve_socp_cuda = halved(base.solve_socp_cuda)


def _altered(altro, base):
    step = altro.altro_iteration

    def altered(*a, **kw):
        st = step(*a, **kw)
        X = st.X.clone()
        X[:, X.shape[1] // 2, 0] += 1e-3
        return st._replace(X=X)
    altro.altro_iteration = altered


FAULTS = {"unchanged": _unchanged, "frozen": _frozen, "no_dual": _no_dual,
          "half_batch": _half_batch, "altered": _altered}


@contextlib.contextmanager
def planted(name: str):
    """The port with fault ``name`` planted, restored on exit."""
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import base

    saved = [(altro, "altro_iteration", altro.altro_iteration),
             (base, "solve_socp", base.solve_socp),
             (base, "solve_socp_cuda", base.solve_socp_cuda)]
    try:
        FAULTS[name](altro, base)
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
