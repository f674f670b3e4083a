"""Observability helpers: timing that waits for the card and host-side
formatting of the solver's metrics.  Port of ``dcol_tpu/utils/metrics.py``;
its profiler trace (``jax.profiler`` there) is
:func:`dcol_tpu_torch.utils.trace.trace`."""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from dcol_tpu_torch.solver.altro import TABLE_HEADER, table_row


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
