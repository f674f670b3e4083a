"""The port's tracing: profiler traces, spans around the solver's and the
scene's phases, and the counts made inside them.

Everything here records only while a ``torch.profiler`` records.  With no
profiler, :func:`span` is one flag check that returns the shared no-op
:data:`OFF`, and nothing is counted.  Under a profiler:

  * each span enters ``torch.profiler.record_function(name)``, so it lands
    in the same trace as the kernels, on the same clock, nested by the
    host thread, and is pushed on a per-thread stack of span names;
  * from entering an outermost span on the main thread to leaving it,
    ``torch.cuda.set_sync_debug_mode("warn")`` is on, and each blocking
    host-device synchronisation it reports is counted under (innermost
    span, ``file:line`` of the port's frame that caused it) instead of
    printed;
  * ``CollisionScene._solve`` notes each conic batch (:meth:`Recorder.note_pdip`),
    ``solver.altro`` each rollout by path (:attr:`Recorder.rollouts`), and
    ``ops.rollout_cuda`` each launch of the rollout kernel with a pair of
    CUDA events around it (:attr:`Recorder.rollout_launches`).

The counts of the latest profiled stretch are in :data:`RECORDER`.  They
are cleared at the first span entered under a profiler after one entered
without: a step run unprofiled and then profiled leaves the profiled
step's counts alone.

Threads: spans record on every thread (the scenario mesh's device threads
included), but synchronisations are counted on the main thread only.  The
debug mode and the ``warnings`` machinery are process-wide, so a
synchronisation another thread makes while the main thread is inside a
span is dropped, neither counted nor printed.

Span names (:data:`SPANS`): ``mpc.tick``, ``altro.initial_state``,
``altro.iteration``, ``altro.backward.jacobians``, ``altro.backward.polish``,
``altro.backward.riccati``, ``altro.forward.probe``, ``altro.forward.chunk``,
``altro.rollout``, ``altro.duals``, ``scene.assemble``, ``scene.solve``,
``scene.envelope``.  A span named ``altro.*`` or ``mpc.*`` is the solver's,
``scene.*`` the scene's (:data:`LAYERS`)."""

from __future__ import annotations

import bisect
import collections
import contextlib
import os
import sys
import threading
import warnings
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

TRACE_FILE = "trace.json"

SPANS = ("mpc.tick", "altro.initial_state", "altro.iteration",
         "altro.backward.jacobians", "altro.backward.polish",
         "altro.backward.riccati", "altro.forward.probe",
         "altro.forward.chunk", "altro.rollout", "altro.duals",
         "scene.assemble", "scene.solve", "scene.envelope")
LAYERS = {"altro": "solver", "mpc": "solver", "scene": "scene"}

# the warning ``set_sync_debug_mode("warn")`` gives for each synchronisation,
# and the one it gives once when first set
SYNC_MESSAGE = "called a synchronizing CUDA operation"
PROTOTYPE_MESSAGE = "Synchronization debug mode is a prototype feature"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_HERE = os.path.abspath(__file__)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block on the host and, where there is one, the card
    (``torch.profiler``); the Chrome trace goes to
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class Recorder:
    """What the latest profiled stretch counted.

    ``syncs``: {(innermost span, ``file:line``): count} of blocking
    synchronisations, where ``file`` is relative to the package;
    ``sync_counted`` says whether the debug mode was on (a card present).
    ``rollouts``: {path: count} of the solver's rollouts, ``"kernel"``
    (one launch of ``ops.rollout_cuda``) or ``"loop"`` (the plain loop).
    ``rollout_launches``: one dict per launch of the rollout kernel: its
    ``system`` (the kernel's name), ``dtype`` (``"float32"`` or
    ``"float64"``), ``S``, ``C``, ``N``, ``closed`` (the closed loop, or the
    open one), and ``start`` and ``end``, CUDA events (timing) recorded
    around it on its stream; ``start.elapsed_time(end)`` is its time in ms
    once the stream has passed ``end``.
    ``pdip``: one dict per conic batch with B > 0: its layout ``nv``,
    ``n_ort``, ``s1``, ``s2``, ``B``, ``start`` (``cold``, ``warm`` or
    ``warm+skip``), and on the batch's device ``iters`` (its summed
    Mehrotra iterations, one reduction) and ``skip`` (the caller's mask,
    reduced when read)."""

    def __init__(self):
        self.syncs: collections.Counter = collections.Counter()
        self.sync_counted = False
        self.pdip: List[Dict] = []
        self.rollouts: collections.Counter = collections.Counter()
        self.rollout_launches: List[Dict] = []

    def clear(self):
        self.syncs.clear()
        self.sync_counted = False
        self.pdip.clear()
        self.rollouts.clear()
        self.rollout_launches.clear()

    def note_pdip(self, c, lay, warm, skip, sol):
        """Note one conic batch: problems c (B, nv) of cone layout ``lay``
        solved into ``sol`` (an ``SocpSolution``)."""
        self.pdip.append({
            "nv": c.shape[-1], "n_ort": lay.n_ort, "s1": lay.s1,
            "s2": lay.s2, "B": c.shape[0],
            "start": ("cold" if warm is None else
                      "warm" if skip is None else "warm+skip"),
            # int32 in and out, one kernel: B x max_iters stays far
            # below 2**31
            "iters": sol.iters.sum(dtype=torch.int32), "skip": skip})

    def pdip_totals(self) -> Dict[str, Dict[str, int]]:
        """{start: {"batches", "problems", "iters"}}: the batches noted,
        the problems solved (B less those skipped) and their Mehrotra
        iterations, summed by start kind (reduced here, one host copy a
        batch)."""
        out: Dict[str, Dict[str, int]] = {}
        for r in self.pdip:
            t = out.setdefault(r["start"], {"batches": 0, "problems": 0,
                                            "iters": 0})
            skipped = 0 if r["skip"] is None else int(r["skip"].sum())
            t["batches"] += 1
            t["problems"] += r["B"] - skipped
            t["iters"] += int(r["iters"])
        return out

    def layer_syncs(self, layer: str) -> Optional[int]:
        """Synchronisations counted under the spans of ``layer``
        (``solver`` or ``scene``), or None where none were counted."""
        if not self.sync_counted:
            return None
        return sum(n for (name, _), n in self.syncs.items()
                   if LAYERS.get(name.split(".")[0]) == layer)


RECORDER = Recorder()


class _Off:
    """The span of an unprofiled run: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()
_local = threading.local()
_idle = True        # a span was entered without a profiler since the last
                    # clear


def recording() -> bool:
    """Whether a ``torch.profiler`` records."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context manager around one phase: :data:`OFF` while no profiler
    records, else a span that records as the module's docstring says."""
    global _idle
    if not _profiler._is_profiler_enabled:
        _idle = True
        return OFF
    return _Span(name)


def _stack() -> List[str]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "rf", "watch")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _idle
        if _idle:
            RECORDER.clear()
            _idle = False
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = _stack()
        self.watch = None
        if not stack and threading.current_thread() is threading.main_thread():
            self.watch = _SyncWatch.start()
        stack.append(self.name)
        return None

    def __exit__(self, *exc):
        _stack().pop()
        try:
            if self.watch is not None:
                self.watch.stop()
        finally:
            self.rf.__exit__(*exc)
        return False


_SITES: Dict[str, Optional[str]] = {}


def _site() -> str:
    """``file:line`` of the innermost frame of the port (this module
    excepted) on the calling thread's stack."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        rel = _SITES.get(fn, "")
        if rel == "":
            path = os.path.abspath(fn)
            rel = (path[len(_PKG):].replace(os.sep, "/")
                   if path.startswith(_PKG) and path != _HERE else None)
            _SITES[fn] = rel
        if rel is not None:
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return "?"


class _SyncWatch:
    """``set_sync_debug_mode("warn")`` with its warnings counted in
    :data:`RECORDER` and none shown (nor the one that the mode is a
    prototype); :meth:`stop` restores the mode, the warning filters and
    ``warnings.showwarning``.  On an H100 with torch 2.11 the mode reported
    every synchronisation the CUDA runtime traced inside the port's spans
    (PERF.md §5)."""

    def __init__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        self.catcher = warnings.catch_warnings()
        self.catcher.__enter__()
        self.shown = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        warnings.filterwarnings("ignore", message=PROTOTYPE_MESSAGE)
        warnings.showwarning = self._show
        torch.cuda.set_sync_debug_mode("warn")
        RECORDER.sync_counted = True

    @classmethod
    def start(cls) -> Optional["_SyncWatch"]:
        return cls() if torch.cuda.is_available() else None

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if not str(message).startswith(SYNC_MESSAGE):
            self.shown(message, category, filename, lineno, file, line)
        elif threading.current_thread() is threading.main_thread():
            stack = _stack()
            RECORDER.syncs[(stack[-1] if stack else "", _site())] += 1

    def stop(self):
        try:
            torch.cuda.set_sync_debug_mode(self.mode)
        finally:
            self.catcher.__exit__(None, None, None)


# -- reading an exported trace ---------------------------------------------

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaLaunchCooperativeKernel")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cuStreamSynchronize", "cuCtxSynchronize")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _overlap(a: List[tuple], b: List[tuple]) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def coverage(events: List[Dict], t0: float, t1: float) -> Dict:
    """How much of a stretch ``[t0, t1]`` (microseconds) of an exported
    Chrome trace the port's spans hold: the card's idle time (no kernel,
    copy or set running) and the idle time while some host thread is inside
    a port span; the CUDA launch calls and synchronisations, and those made
    inside a port span on their own thread."""
    X = [e for e in events if e.get("ph") == "X"
         and t0 <= e["ts"] <= t1]
    spans: Dict = collections.defaultdict(list)
    for e in X:
        if e.get("cat") == "user_annotation" and e["name"] in SPANS:
            spans[e.get("tid")].append((e["ts"], e["ts"] + e["dur"]))
    spans = {tid: _union(iv) for tid, iv in spans.items()}
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in X
                   if e.get("cat") in DEVICE_CATS])
    idle, at = [], t0
    for a, b in busy:
        if a > at:
            idle.append((at, min(a, t1)))
        at = max(at, b)
    if at < t1:
        idle.append((at, t1))
    in_span = _union([iv for ivs in spans.values() for iv in ivs])

    starts = {tid: [a for a, _ in iv] for tid, iv in spans.items()}

    def inside(e):
        tid = e.get("tid")
        i = bisect.bisect_right(starts.get(tid, ()), e["ts"]) - 1
        return i >= 0 and e["ts"] <= spans[tid][i][1]

    rt = [e for e in X if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launches = [e for e in rt if e["name"] in LAUNCH_CALLS]
    syncs = [e for e in rt if e["name"] in SYNC_CALLS]
    return {"idle_us": sum(b - a for a, b in idle),
            "idle_in_spans_us": _overlap(idle, in_span),
            "launches": len(launches),
            "launches_in_spans": sum(map(inside, launches)),
            "syncs": len(syncs), "syncs_in_spans": sum(map(inside, syncs))}
