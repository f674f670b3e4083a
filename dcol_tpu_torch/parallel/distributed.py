"""Multi-process scenario-parallel solves with ``torch.distributed``: one
process per device, NCCL between GPUs, gloo between CPU processes.  Port of
``dcol_tpu/parallel/distributed.py``.

The workload is embarrassingly parallel over scenarios, so every process
solves its own rows and the only collectives are the aggregate metrics:

  * :func:`initialize` joins the process group (``tcp://`` rendezvous);
  * :func:`global_scenario_mesh` is the 1-D device mesh of every process;
  * :func:`scatter_local` places this process's rows on its device and
    records their range in the global batch (no cross-process copy);
  * :func:`solve_scattered` checks its shard against the mesh and solves it;
  * :func:`gather_metrics` reduces ``summarize``'s metrics over all ranks.

Start one process per GPU with ``torchrun --nproc-per-node <gpus>``, or
spawn them yourself and pass each its rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from dcol_tpu_torch.solver import altro

AXIS = "scenario"


class ScenarioShard(NamedTuple):
    """This process's rows of a global scenario batch, on its device."""
    data: object        # the local rows: a tensor or (named) tuple / dict
    mesh: DeviceMesh
    lo: int             # the rows [lo, hi) of the global batch
    hi: int
    n_global: int


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device) -> None:
    """Join the process group: NCCL for a CUDA ``device`` (which becomes
    this process's current device), gloo for the CPU.  A CUDA device
    without CUDA raises; nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs CUDA, and torch.cuda is not "
                               "available")
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device}")
    addr = coordinator_address
    dist.init_process_group(
        backend, init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group."""
    dist.destroy_process_group()


def global_scenario_mesh() -> DeviceMesh:
    """A 1-D mesh over every process's device (one device a process)."""
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(AXIS,))


def _local_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _first(tree):
    if isinstance(tree, dict):
        return _first(next(iter(tree.values())))
    if isinstance(tree, tuple):
        return _first(tree[0])
    return tree


def scatter_local(mesh: DeviceMesh, local_batch) -> ScenarioShard:
    """This process's rows of the global batch (leading dim = its
    scenarios; tensors or numpy arrays) placed on its device.  Every
    process holds as many rows; its range in the global batch follows from
    its rank."""
    dev = _local_device(mesh)
    data = altro.tree_map(lambda a: torch.as_tensor(a).to(dev),
                          local_batch)
    n = int(_first(data).shape[0])
    rank, world = mesh.get_rank(), mesh.size()
    return ScenarioShard(data, mesh, rank * n, (rank + 1) * n, world * n)


def solve_scattered(sys, mesh: DeviceMesh, shard: ScenarioShard,
                    cfg: altro.AltroConfig):
    """Solve this process's rows of a scattered batch; ``shard.data`` is
    (params_b, X0_b, U0_b).  The shard must come from :func:`scatter_local`
    over this ``mesh`` and lie on this process's device; a mismatch means
    the caller scattered over another mesh than it solves on, and raises."""
    if not isinstance(shard, ScenarioShard):
        raise ValueError("solve_scattered expects the ScenarioShard of "
                         f"scatter_local, got {type(shard).__name__}")
    if (shard.mesh.device_type != mesh.device_type
            or shard.mesh.mesh_dim_names != mesh.mesh_dim_names
            or not torch.equal(shard.mesh.mesh, mesh.mesh)):
        raise ValueError(f"the shard was scattered over {shard.mesh}, not "
                         f"over {mesh}")
    params_b, X0_b, U0_b = shard.data
    dev = _local_device(mesh)
    if X0_b.device != dev:
        raise ValueError(f"the shard lies on {X0_b.device}, this process's "
                         f"device is {dev}")
    if shard.hi - shard.lo != X0_b.shape[0]:
        raise ValueError(f"the shard holds {X0_b.shape[0]} rows, its range "
                         f"[{shard.lo}, {shard.hi})")
    return altro.solve(sys, params_b, cfg, X0_b, U0_b)


def gather_metrics(state) -> dict:
    """``summarize``'s metrics over every rank's rows, by ``all_reduce``:
    SUM for the counts and the iteration sum, MAX for ``convio``.  Every
    rank gets the same dict."""
    dev = state.iter.device
    sums = torch.stack([
        torch.tensor(float(state.converged.shape[0]), dtype=torch.float64,
                     device=dev),
        state.converged.double().sum(), state.failed.double().sum(),
        state.iter.double().sum()])
    cmax = state.convio.max().double().reshape(1)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    dist.all_reduce(cmax, op=dist.ReduceOp.MAX)
    n, n_conv, n_fail, it_sum = sums.tolist()
    return {"n": int(n), "n_converged": int(n_conv), "n_failed": int(n_fail),
            "mean_iters": it_sum / n, "max_convio": float(cmax)}


def main(argv=None):
    """One process of a multi-process batch solve, started by ``torchrun``
    (which sets RANK, WORLD_SIZE, LOCAL_RANK and the rendezvous address):

        torchrun --standalone --nproc-per-node <gpus> \\
            -m dcol_tpu_torch.parallel.distributed [--system quadrotor]
            [--batch 128] [--device cuda|cpu]

    Every process makes the same ``perturb_scenarios(seed=0,
    x0_sigma=0.02)`` batch on the host, scatters its contiguous rows to its
    device (``cuda:LOCAL_RANK``), solves them, and rank 0 prints the
    reduced metrics.  The batch must divide by the number of processes."""
    import argparse
    import os
    import time

    from dcol_tpu_torch.parallel.batch import perturb_scenarios
    from dcol_tpu_torch.systems import (
        cone_through_wall, piano_mover, quadrotor)

    parser = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    parser.add_argument("--system", default="quadrotor",
                        choices=["piano_mover", "quadrotor",
                                 "coneThroughWall"])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if args.batch % world:
        raise ValueError(f"batch {args.batch} does not divide by {world} "
                         "processes")
    device = (torch.device("cuda", int(os.environ["LOCAL_RANK"]))
              if args.device == "cuda" else torch.device("cpu"))
    initialize("env://", world, rank, device)
    try:
        mod = {"piano_mover": piano_mover, "quadrotor": quadrotor,
               "coneThroughWall": cone_through_wall}[args.system]
        dtype = torch.float32 if args.device == "cuda" else torch.float64
        sys_, params, X0, U0, cfg = mod.make_problem(dtype, "cpu")
        pb, xb, ub = perturb_scenarios(params, X0, U0, n=args.batch, seed=0,
                                       x0_sigma=0.02)
        n = args.batch // world
        rows = slice(rank * n, (rank + 1) * n)
        mesh = global_scenario_mesh()
        shard = scatter_local(mesh, ({k: v[rows] for k, v in pb.items()},
                                     xb[rows], ub[rows]))
        dist.barrier()
        t0 = time.perf_counter()
        st = solve_scattered(sys_, mesh, shard, cfg)
        summary = gather_metrics(st)
        wall = time.perf_counter() - t0
        if rank == 0:
            print(f"{args.batch} {args.system} scenarios over {world} "
                  f"processes ({mesh.device_type}) in {wall:.2f}s: {summary}")
    finally:
        shutdown()


if __name__ == "__main__":
    main()
