"""Observability helpers: profiler traces, timing that waits for the card,
throughput, and host-side formatting of the solver's metrics.  Port of
``dcol_tpu/utils/metrics.py``, with ``torch.profiler`` where the JAX
package has ``jax.profiler``."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator

import numpy as np
import torch

from dcol_tpu_torch.solver.altro import TABLE_HEADER, table_row

TRACE_FILE = "trace.json"


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


def _cuda_devices(tree) -> set:
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*(_cuda_devices(a) for a in tree)) if tree else set()
    if isinstance(tree, torch.Tensor) and tree.is_cuda:
        return {tree.device}
    return set()


def block(tree):
    """Wait for the devices of a tree's CUDA tensors; returns the tree."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)
    return tree


class Timer:
    """Wall-clock timer; on exit it waits for the work queued on the card,
    when there is a card."""

    def __enter__(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self.t0


def throughput(fn, *args, reps: int = 5, warmup: int = 1) -> dict:
    """{wall_s, per_call_s} of ``fn(*args)`` over ``reps`` calls after
    ``warmup`` calls (the first calls build the kernels)."""
    for _ in range(warmup):
        block(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    block(out)
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "per_call_s": wall / reps}


def iteration_table(state, member: int = 0, limit: int | None = None) -> str:
    """Format one scenario's metric ring buffer like the reference's stdout
    table (ALTRO.py:437-440)."""
    m = state.metrics
    nb = m.J.shape[-1]
    it = int(state.iter[member])
    n = min(it, nb)
    if limit:
        n = min(n, limit)
    lines = []
    if it > nb:
        lines.append(
            f"[metrics buffer truncated: {it} iterations ran but the buffer "
            f"holds {nb}; iterations {nb}..{it} all wrote the last slot - "
            "raise AltroConfig.metrics_len for the full history]")
    lines.append(TABLE_HEADER)
    rows = [a[member, :n].tolist() for a in
            (m.J, m.delta_J, m.kmax, m.alpha, m.reg, m.rho)]
    lines += [table_row(i + 1, *r) for i, r in enumerate(zip(*rows))]
    return "\n".join(lines)


def batch_summary_json(batched_state, wall_s: float) -> str:
    """One-line JSON summary of a solved batch (solves/s, convergence);
    the keys of the JAX package's."""
    st = batched_state
    n = int(st.converged.shape[0])
    iters = st.iter.cpu().numpy()
    return json.dumps({
        "n_scenarios": n,
        "solves_per_s": round(n / wall_s, 3),
        "converged": int(st.converged.sum()),
        "failed": int(st.failed.sum()),
        "mean_iters": round(float(iters.mean()), 2),
        "p50_iters": float(np.percentile(iters, 50)),
        "max_convio": float(st.convio.max()),
    })
