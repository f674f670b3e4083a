"""Scenario sharding over the GPUs of one process.  Port of
``dcol_tpu/parallel/mesh.py``.

The horizon is short and the Riccati recursion sequential, so the axis to
spread over devices is the scenario batch: shards are independent and need
collectives only for aggregate metrics.  Here a mesh is a list of
``torch.device``s; :func:`solve_batch_sharded` solves one contiguous shard a
device, each GPU's from its own host thread.  Those threads share one
process's interpreter lock, so the eager launches of every shard queue
through one host thread's dispatch; the path that scales across GPUs is one
process per device (:mod:`dcol_tpu_torch.parallel.distributed`).  The
forward-mode AD of the solver runs under a lock for the same threads
(:func:`dcol_tpu_torch.systems.base.jvp`).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import torch

from dcol_tpu_torch.solver import altro


def scenario_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices to shard scenarios over: every CUDA device by default.
    Raises without a CUDA device; a CPU mesh is asked for by passing its
    devices (``[torch.device("cpu")] * k`` for k shards)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("scenario_mesh(): no CUDA device; pass "
                               "devices= for a CPU mesh")
        return [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("scenario_mesh(): empty device list")
    return devices


def _bounds(n: int, k: int) -> List[tuple]:
    """Row ranges of k contiguous shards of n rows (sizes differ by <= 1)."""
    cuts = [i * n // k for i in range(k + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def shard_scenarios(mesh: Sequence[torch.device], params_b, X0_b, U0_b):
    """Contiguous shards of a scenario batch, one per mesh device, each
    placed on its device: a list of (params, X0, U0).  The batch must have
    at least one scenario a device."""
    n = X0_b.shape[0]
    if n < len(mesh):
        raise ValueError(f"{n} scenarios cannot shard over {len(mesh)} "
                         "devices")
    return [({k: v[lo:hi].to(d) for k, v in params_b.items()},
             X0_b[lo:hi].to(d), U0_b[lo:hi].to(d))
            for d, (lo, hi) in zip(mesh, _bounds(n, len(mesh)))]


def solve_batch_sharded(sys, mesh: Sequence[torch.device], params_b,
                        cfg: altro.AltroConfig, X0_b, U0_b):
    """Scenario-sharded batched solve: each GPU solves its shard from its
    own host thread (a CPU mesh's shards run in turn); returns one
    ``AltroState`` on the mesh's first device.  Per scenario it is the
    solve of :func:`dcol_tpu_torch.parallel.batch.solve_batch`."""
    if len({d.type for d in mesh}) != 1:
        raise ValueError(f"a mesh holds devices of one type, got {mesh}")
    shards = shard_scenarios(mesh, params_b, X0_b, U0_b)

    def solve(dev, shard):
        p, x, u = shard
        with torch.cuda.device(dev):
            st = altro.solve(sys, p, cfg, x, u)
            torch.cuda.current_stream(dev).synchronize()
            return st

    if mesh[0].type == "cuda":
        with ThreadPoolExecutor(max_workers=len(mesh)) as ex:
            outs = list(ex.map(solve, mesh, shards))
    else:
        # The shards of a CPU mesh share the CPU, and threads of tiny eager
        # ops queue on the GIL at 3-5x the serial cost: one after another.
        outs = [altro.solve(sys, p, cfg, x, u) for p, x, u in shards]
    return altro.tree_map(lambda *a: torch.cat([t.to(mesh[0]) for t in a]),
                          *outs)


def summarize(batched_state) -> dict:
    """Aggregate metrics of a solved batch (the sums and maximum that
    :func:`dcol_tpu_torch.parallel.distributed.gather_metrics` reduces
    across processes)."""
    st = batched_state
    n = int(st.converged.shape[0])
    return {
        "n": n,
        "n_converged": int(st.converged.sum()),
        "n_failed": int(st.failed.sum()),
        "mean_iters": float(st.iter.double().sum()) / n,
        "max_convio": float(st.convio.max()),
    }
