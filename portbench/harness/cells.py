"""The two kinds of traffic a mix can ask for, driven through the port.

``plan``: batches of perturbed scenarios solved back to back by one
client (closed loop): ``altro.make_initial_state``, then ``altro.iterate``
whose ``callback`` marks each iteration's end and counts the scenarios
that were active in it (not yet converged or failed, by the flags the
program reported before it).  A batch that finishes is followed by the
next, drawn from the seed and its index.

``mpc``: one batch of scenarios under receding-horizon control,
``mpc.mpc_run(n_steps=1, resume_from=...)`` tick after tick; set-up runs
the mix's ``warmup_ticks`` first ticks, whose cost still climbs, so that
the window holds the steady ticks.

Each keeps a sample of its answers, drawn from the seed, for the
comparison with the plain reference after the window; a planning batch
also keeps its sample's trajectories at iteration ``progress_iter``
(iterated on after the window, untimed, where the window ended before
it), whose progress the reference judges.  ``traced_step`` rebuilds the
mix's fixed traced step (``trace_iter`` of batch 0, or tick
``trace_tick``) from the seed, whatever the window reached."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench.harness import traffic
from portbench.harness.program import Program


class _Stop(Exception):
    def __init__(self, st):
        super().__init__()
        self.st = st


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample_rows(seed: int, batch: int, n: int, k: int) -> np.ndarray:
    """The ``k`` scenarios of batch ``batch`` that are judged."""
    rng = np.random.default_rng([seed, batch, 1])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


class PlanCell:
    kind = "plan"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.prog = Program(config, config["N"])
        self.batch = -1
        self.judged: List[Dict] = []
        self.touched = 0

    # -- batches -----------------------------------------------------------
    def _start(self, batch: int):
        """(params, initial state) of batch ``batch``."""
        from dcol_tpu_torch.solver import altro

        pb, xb, ub = traffic.scenarios(self.config, self.mix, self.seed,
                                       batch, self.device)
        return pb, altro.make_initial_state(self.prog.sys, pb, self.prog.cfg,
                                            xb, ub)

    def _advance(self, pb, st, n: int):
        """(``st`` after ``n`` more iterations, the iterations run: fewer
        where every scenario finishes first)."""
        from dcol_tpu_torch.solver import altro

        if n <= 0:
            return st, 0
        done = 0

        def cb(itr, s):
            nonlocal done
            done += 1
            if done >= n:
                raise _Stop(s)
        try:
            st = altro.iterate(self.prog.sys, pb, self.prog.cfg, st,
                               callback=cb)
        except _Stop as e:
            st = e.st
        return st, done

    def _new_batch(self):
        self.batch += 1
        self.touched += 1
        self.pb, self.st = self._start(self.batch)
        S = self.st.X.shape[0]
        self.rows = sample_rows(self.seed, self.batch, S, self.mix["judged"])
        self.it = torch.as_tensor(self.rows, device=self.device)
        # the harness's own count of the iterations each scenario was in
        self.count = torch.zeros(S, dtype=torch.int32, device=self.device)
        self.done = torch.zeros(S, dtype=torch.bool, device=self.device)
        self.batch_iter = 0
        self.snap = None

    def _take(self, a):
        return a.index_select(0, self.it)

    def _snapshot(self, st):
        """The sample's trajectories at this point of the batch."""
        self.snap = {"iter": self.batch_iter, "X": self._take(st.X),
                     "U": self._take(st.U)}

    def _keep(self):
        """Keep the judged sample of the current batch's state."""
        st, take = self.st, self._take
        self.judged.append({
            "batch": self.batch, "rows": self.rows, "X": take(st.X),
            "U": take(st.U), "hx": take(st.hx), "iter": take(st.iter),
            "count": take(self.count), "converged": take(st.converged),
            "failed_flag": take(st.failed), "failed": st.failed.sum(),
            "iterated": self.batch_iter, "snap": self.snap})

    def steps(self, until: float = None, max_steps: int = None,
              record: list = None, one_batch: bool = False) -> int:
        """Iterate (batch after batch) until the clock passes ``until`` or
        ``max_steps`` iterations are done; each iteration's (end time,
        scenarios active in it) goes to ``record``.  With ``one_batch``
        stop where the batch finishes, without starting the next."""
        from dcol_tpu_torch.solver import altro

        n_steps = 0

        def cb(itr, st):
            nonlocal n_steps
            active = ~self.done
            n = int(active.sum())                 # waits for the iteration
            t = time.perf_counter()
            self.count += active.to(torch.int32)
            self.done = st.converged | st.failed
            n_steps += 1
            self.batch_iter += 1
            if self.batch_iter == self.mix["progress_iter"]:
                self._snapshot(st)
            if record is not None:
                record.append((t, n))
            if ((until is not None and t >= until)
                    or (max_steps is not None and n_steps >= max_steps)):
                raise _Stop(st)

        while True:
            try:
                self.st = altro.iterate(self.prog.sys, self.pb, self.prog.cfg,
                                        self.st, callback=cb)
            except _Stop as e:
                self.st = e.st
                return n_steps
            if self.snap is None:                 # finished before it
                self._snapshot(self.st)
            self._keep()
            if one_batch:
                return n_steps
            self._new_batch()
            if until is not None and time.perf_counter() >= until:
                return n_steps

    def setup(self):
        """Batch 0 and one iteration of it: every shape the window uses."""
        self._new_batch()
        self.steps(max_steps=1)
        _sync(self.device)

    def finish(self):
        """Keep the sample of the batch in progress; where the window
        ended before its ``progress_iter``, iterate it there first
        (untimed: the answer is waited for, not counted)."""
        kept = len(self.judged)
        if self.batch_iter > 0 and self.snap is None:
            self.steps(max_steps=self.mix["progress_iter"] - self.batch_iter,
                       one_batch=True)
        if len(self.judged) == kept:
            self._keep()

    def release(self):
        """Drop the window's batch; the kept samples stay."""
        self.pb = self.st = self.count = self.done = None

    def traced_step(self) -> Callable[[], float]:
        """A function that runs iteration ``trace_iter`` of batch 0, made
        anew from the seed, and returns the iterations it ran; each call
        runs it from the same state."""
        pb, st = self._start(0)
        st, _ = self._advance(pb, st, self.mix["trace_iter"] - 1)

        def one():
            return float(self._advance(pb, st, 1)[1])
        return one

    def attempted_failed(self):
        failed = sum(int(j["failed"]) for j in self.judged)
        return self.touched * self.mix["scenarios"], failed


class MpcCell:
    kind = "mpc"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.prog = Program(config, mix["horizon"])
        self.tick_cfg = self.prog.tick_config(mix["tick_iters"])
        self.pb, xb, self.U0 = traffic.scenarios(config, mix, seed, 0, device)
        self.x0 = xb[:, 0]
        idx = sample_rows(seed, 0, xb.shape[0], mix["judged"])
        self.rows = idx
        self.it = torch.as_tensor(idx, device=device)
        self.carry = None
        self.judged: List[Dict] = []

    def _run_tick(self, carry):
        from dcol_tpu_torch.solver import mpc

        return mpc.mpc_run(self.prog.sys, self.pb, self.tick_cfg, self.x0,
                           self.U0, 1, carry_duals=self.mix["carry_duals"],
                           resume_from=carry)

    def _tick(self):
        res = self._run_tick(self.carry)
        take = lambda a: a.index_select(0, self.it)
        # the plan the tick started from and the one it applied: the
        # first control, then the rest as the carry shifts them
        before = self.U0 if self.carry is None else self.carry.U
        self.judged.append({"tick": len(self.judged),
                            "x": take(res.X_applied[:, 0]),
                            "u": take(res.U_applied[:, 0]),
                            "x_next": take(res.X_applied[:, 1]),
                            "h": take(res.h_applied[:, 0]),
                            "iters": take(res.iters[:, 0]),
                            "U_start": take(before),
                            "U_next": take(res.final.U),
                            "nonfinite": (~torch.isfinite(
                                res.X_applied[:, 1]).all(-1)).sum()})
        self.carry = res.final
        return res

    def steps(self, until: float = None, max_steps: int = None,
              record: list = None) -> int:
        """Ticks until the clock passes ``until`` or ``max_steps`` ticks
        are done; each tick's (end time, 1) goes to ``record``."""
        n = 0
        while True:
            res = self._tick()
            int(res.iters.max())                  # waits for the tick
            t = time.perf_counter()
            n += 1
            if record is not None:
                record.append((t, 1.0))
            if ((until is not None and t >= until)
                    or (max_steps is not None and n >= max_steps)):
                return n

    def setup(self):
        """Ticks 0 to ``warmup_ticks`` - 1: every shape the window uses,
        and the climb of the first ticks' cost."""
        self.steps(max_steps=self.mix["warmup_ticks"])
        _sync(self.device)

    def finish(self):
        pass

    def release(self):
        self.carry = None

    def traced_step(self) -> Callable[[], float]:
        """A function that runs tick ``trace_tick`` of the closed loop,
        made anew from the seed, and returns the ALTRO iterations of the
        tick; each call runs it from the same carry."""
        carry = None
        for _ in range(self.mix["trace_tick"]):
            carry = self._run_tick(carry).final

        def one():
            return float(self._run_tick(carry).iters.max())
        return one

    def attempted_failed(self):
        bad = sum(int(j["nonfinite"]) for j in self.judged)
        return len(self.judged) * self.mix["scenarios"], bad


KINDS = {"plan": PlanCell, "mpc": MpcCell}
