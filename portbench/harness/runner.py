"""One run of one cell: set-up, the measured window, the optional traced
stretch, the comparison with the reference, and the result line."""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, Optional

import torch

from portbench.harness import check, window
from portbench.harness import trace as tracing
from portbench.harness.cells import KINDS
from portbench.harness.registry import Registry


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(reg: Registry, name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float,
             control: bool = False) -> Dict:
    """The result of one run; ``t_start`` is when the process started.
    With ``control`` the numbers also hold the control's readings (the
    result's ``numbers``)."""
    cell = reg.cell(name)
    config, mix = reg.config(cell["config"]), reg.mix(cell["traffic"])
    ref = reg.reference(cell["config"])
    run = KINDS[mix["kind"]](config, mix, seed, device)
    run.setup()
    setup_s = time.perf_counter() - t_start
    log(f"{name}: seed {seed}, set-up {setup_s:.3f} s")

    record = []
    t0 = time.perf_counter()
    run.steps(until=t0 + seconds, record=record)
    work, elapsed, n_steps = window.rate(t0, seconds, record)
    ends = [t0] + [t for t, _ in record]
    log(f"{name}: {n_steps} steps, work {work:.0f} in {elapsed:.3f} s; "
        "step seconds " + " ".join(f"{b - a:.3f}" for a, b in
                                   zip(ends, ends[1:])))

    ctx = {"kind": mix["kind"], "setup_s": setup_s,
           "window": {"work": work, "elapsed": elapsed, "steps": n_steps},
           "trace": None}
    run.finish()
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted, failed = run.attempted_failed()
    run.release()

    breakdown, extra_device = None, {}
    if trace:
        # the mix's fixed traced step, rebuilt from the seed: once
        # unprofiled for the wall, then the same step profiled
        one = run.traced_step()
        _sync(device)
        tu = time.perf_counter()
        iters = one()
        _sync(device)
        unprof = time.perf_counter() - tu
        red = tracing.profile(one, device)
        red.update(iters=red["steps"], unprofiled_wall_s=unprof,
                   unprofiled_iters=iters)
        ctx["trace"] = red
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}
        extra_device = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
        power = tracing.power_limit()
        if power:
            extra_device["power_limit"] = power
        log(f"{name}: traced step ({iters:g} iterations): "
            f"{red['window_s']:.3f} s profiled, "
            f"{red['busy_s']:.3f} s busy, {red['launches']} launches, "
            f"{red['syncs']} syncs, {red['pdip_kernels']} PDIP kernels "
            f"({red['pdip_calls']} calls, launches unseen by the runtime "
            f"trace: {red['pdip_unseen']}); unprofiled {unprof:.3f} s; "
            f"card {power}")
    metrics = reg.read_metrics(name, "per_layer" if trace else "end_to_end",
                               ctx)

    # the reference runs after the program's state is freed
    judged, rows = run.judged, getattr(run, "rows", None)
    convio_tol = run.prog.cfg.convio_tol
    del run
    if cuda:
        torch.cuda.empty_cache()
    tr = time.perf_counter()
    if mix["kind"] == "plan":
        numbers = check.plan_numbers(ref, config, mix, seed, judged,
                                     convio_tol, control)
    else:
        numbers = check.mpc_numbers(ref, config, mix, seed, rows, judged,
                                    control)
    limits = check.limits_of(reg.limits(name), convio_tol)
    correct, compared = check.judge(numbers, limits)
    log(f"{name}: reference check of {numbers['judged']} answers in "
        f"{time.perf_counter() - tr:.3f} s")

    dev: Dict = {"platform": "gpu" if cuda else "cpu",
                 "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                 "count": 1, "memory_peak_bytes": int(peak)}
    dev.update(extra_device)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
    if control:
        out["numbers"] = numbers
    if trace:
        for r in ctx["trace"]["pdip"]:
            log(f"pdip {r['start']} B={r['B']}: {r['seconds'] * 1e3:.4f} ms, "
                f"bound {r['bound_s'] * 1e3:.4f} ms")
    log(f"{name}: numbers " + json.dumps(numbers))
    log(f"{name}: run {time.perf_counter() - t_start:.3f} s so far")
    for k, v, lim in compared:
        log(f"check {k} {v!r} limit {lim!r}")
    return out


def require_cuda(chips: int) -> Optional[str]:
    """Why the run cannot go on, or None."""
    if not torch.cuda.is_available():
        return "no CUDA device: torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, torch sees "
                f"{torch.cuda.device_count()}")
    return None
