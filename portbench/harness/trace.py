"""A profiled stretch of whole steps, and what the per-layer metrics read
from it.

Spans: during the stretch the harness wraps the port's layer entry points
(:func:`_layer_spans`) in ``torch.profiler.record_function`` from outside the
program, and the PDIP kernel's wrapper at its call site to note each
launch's shape, start, skipped count and iteration sum.  The trace is
exported under ``TMPDIR``, read and deleted."""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional

import torch

from portbench.harness import roofline, window

STRETCH = "portbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch",
            "cudaLaunchCooperativeKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
         "cuStreamSynchronize", "cuCtxSynchronize")
PDIP_KERNEL = "pdip_kernel"
TOP = 10


def _layer_spans():
    """(owner, attribute, span name) of each layer entry wrapped."""
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import base

    return ((altro, "backward_pass", "solver.backward_pass"),
            (altro, "forward_pass", "solver.forward_pass"),
            (altro, "dynamics_jacobians", "solver.dynamics_jacobians"),
            (altro, "rollout", "solver.rollout"),
            (base.System, "constraints_x_traj", "scene.constraints"),
            (base.System, "constraints_x_vg_traj", "scene.constraints_vg"),
            (base.CollisionScene, "_envelope_grads", "scene.envelope_jvp"))


@contextlib.contextmanager
def instrumented(launches: List[Dict]):
    """The port's layer entries wrapped in spans, and each PDIP launch
    noted in ``launches`` (its counts left on the device)."""
    from dcol_tpu_torch.systems import base

    saved = []

    def spanned(fn, name):
        def wrapper(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return wrapper

    def noted(fn):
        def wrapper(c, G, h, lay, **kw):
            with torch.profiler.record_function("conic.pdip"):
                sol = fn(c, G, h, lay, **kw)
            if c.shape[0] > 0:
                skip, warm = kw.get("skip"), kw.get("warm")
                launches.append({
                    "nv": c.shape[-1], "n_ort": lay.n_ort, "s1": lay.s1,
                    "s2": lay.s2, "B": c.shape[0],
                    "start": ("cold" if warm is None else
                              "warm" if skip is None else "warm+skip"),
                    "iters": sol.iters.sum(),
                    "skipped": None if skip is None else skip.sum()})
            return sol
        return wrapper

    try:
        for owner, attr, name in _layer_spans():
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, spanned(fn, name))
        for attr in ("solve_socp_cuda", "solve_socp"):
            fn = getattr(base, attr)
            saved.append((base, attr, fn))
            setattr(base, attr, noted(fn))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def profile(run_steps, device) -> Dict:
    """Run ``run_steps()`` (whole steps, ending in a synchronisation)
    under ``torch.profiler`` with the layer spans on; returns the raw
    reduction of the trace (:func:`reduce`)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    launches: List[Dict] = []
    tmp = tempfile.mkdtemp(prefix="portbench_trace_")
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with instrumented(launches):
                with torch.profiler.record_function(STRETCH):
                    t = time.perf_counter()
                    steps = run_steps()
                    if torch.device(device).type == "cuda":
                        torch.cuda.synchronize(device)
                    wall = time.perf_counter() - t
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    red = reduce(events, launches)
    red.update(steps=steps, profiled_wall_s=wall)
    return red


def _innermost(events, points):
    """For each time in ``points`` (sorted), the stack of (name, cat) of
    the nested host events that contain it, innermost last."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(events) and events[i][0] <= p:
            s, e, name, cat = events[i]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, name, cat))
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append([(n, c) for _, _, n, c in stack])
    return out


def reduce(events: List[Dict], launches: List[Dict]) -> Dict:
    """Counts, device time and idle gaps of the stretch's trace events
    (Chrome trace format, times in microseconds)."""
    X = [e for e in events if e.get("ph") == "X"]
    stretch = [e for e in X if e.get("name") == STRETCH]
    if not stretch:
        raise RuntimeError("the profiled stretch's span is not in the trace")
    st = stretch[0]
    t0, t1, tid = st["ts"], st["ts"] + st["dur"], st.get("tid")
    inside = lambda e: t0 <= e["ts"] <= t1
    dev = [e for e in X if e.get("cat") in DEVICE_CATS and inside(e)]
    rt = [e for e in X if e.get("cat") in ("cuda_runtime", "cuda_driver")
          and inside(e)]
    n_launch = sum(e["name"] in LAUNCHES for e in rt)
    n_sync = sum(e["name"] in SYNCS for e in rt)
    pdip = sorted((e for e in dev if PDIP_KERNEL in e["name"]),
                  key=lambda e: e["ts"])
    launch_corr = {e.get("args", {}).get("correlation") for e in rt
                   if e["name"] in LAUNCHES}
    pdip_unseen = bool(pdip) and not any(
        e.get("args", {}).get("correlation") in launch_corr for e in pdip)
    if pdip_unseen:
        # the kernel's launches from its own library do not show among the
        # runtime calls: count them from the device side
        n_launch += len(pdip)
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    busy_us = window.union_seconds(intervals)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # idle gaps, by what the host thread of the stretch was doing
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e.get("cat"))
                  for e in X if e.get("tid") == tid and inside(e)
                  and e.get("cat") in ("cpu_op", "user_annotation",
                                       "cuda_runtime", "cuda_driver"))
    gaps = [g for g in window.gaps(intervals) if g[0] >= t0 and g[1] <= t1]
    if intervals:
        first, last = min(s for s, _ in intervals), max(e for _, e in intervals)
        gaps = [(t0, first)] + gaps + [(last, t1)]
    stacks = _innermost(host, [g[0] for g in gaps])
    by_gap: Dict[str, float] = {}
    for (a, b), stack in zip(gaps, stacks):
        spans = [n for n, c in stack if c == "user_annotation"
                 and n != STRETCH]
        op = stack[-1][0] if stack else "harness"
        if op == (spans[-1] if spans else STRETCH):
            op = "python"  # between operations, in the span's own code
        label = f"{spans[-1] if spans else 'harness'}: {op}"
        by_gap[label] = by_gap.get(label, 0.0) + (b - a)
    top_gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]
    pdip_rows = []
    if pdip and len(pdip) == len(launches):
        for e, l in zip(pdip, launches):
            acc = roofline.launch(l["nv"], l["n_ort"], l["s1"], l["s2"],
                                  l["start"], l["B"], float(l["iters"]),
                                  0 if l["skipped"] is None
                                  else int(l["skipped"]))
            pdip_rows.append(dict(acc, seconds=e["dur"] * 1e-6,
                                  B=l["B"], start=l["start"]))
    return {
        "window_s": (t1 - t0) * 1e-6, "busy_s": busy_us * 1e-6,
        "launches": n_launch, "syncs": n_sync, "pdip_unseen": pdip_unseen,
        "pdip_kernels": len(pdip), "pdip_calls": len(launches),
        "pdip": pdip_rows,
        "device_ops": [[n, us * 1e-6] for n, us in top_ops],
        "idle_gaps": [[n, us * 1e-6] for n, us in top_gaps],
    }
