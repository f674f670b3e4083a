"""The port's multi-process path for real: two gloo processes on the CPU,
started from this file with torch.multiprocessing, each feeding 2 scenarios
of a 4-scenario f64 piano batch through initialize / scatter_local /
solve_scattered / gather_metrics, mirroring tests/test_distributed.py and
phase 2 of tests/_distributed_worker.py (a per-rank MPC checkpoint and
resume).  The stitched result is held to the JAX package's solve_batch of
the same batch.  The same two processes then run the ``torchrun`` entry
point with the variables torchrun sets."""

import contextlib
import dataclasses
import io
import json
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

torch.set_num_threads(1)

N, MAX_ITERS, PER_RANK, WORLD = 20, 8, 2, 2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _problem():
    from dcol_tpu_torch.parallel.batch import perturb_scenarios
    from dcol_tpu_torch.systems import piano_mover

    sys_, params, X0, U0, cfg = piano_mover.make_problem(torch.float64,
                                                         "cpu", N=N)
    cfg = dataclasses.replace(cfg, max_iters=MAX_ITERS)
    return (sys_, cfg) + perturb_scenarios(params, X0, U0,
                                           n=PER_RANK * WORLD, seed=3,
                                           x0_sigma=0.05)


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def _worker(rank, port, port2, out_dir):
    """One process: its rows of the batch, the reduced metrics, the MPC
    checkpoint and resume, whether mismatched inputs raise, and the
    entry point's output."""
    from torch.distributed.device_mesh import init_device_mesh

    from dcol_tpu_torch.parallel import distributed
    from dcol_tpu_torch.solver import mpc

    torch.set_num_threads(1)
    distributed.initialize(f"localhost:{port}", WORLD, rank, "cpu")
    try:
        sys_, cfg, pb, xb, ub = _problem()
        lo, hi = PER_RANK * rank, PER_RANK * (rank + 1)
        local = ({k: v[lo:hi] for k, v in pb.items()}, xb[lo:hi], ub[lo:hi])
        mesh = distributed.global_scenario_mesh()
        shard = distributed.scatter_local(mesh, local)
        st = distributed.solve_scattered(sys_, mesh, shard, cfg)
        metrics = distributed.gather_metrics(st)
        other = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("other",))
        mismatch = [
            _raises(lambda: distributed.solve_scattered(sys_, mesh, local,
                                                        cfg)),
            _raises(lambda: distributed.solve_scattered(sys_, other, shard,
                                                        cfg)),
            _raises(lambda: distributed.solve_scattered(
                sys_, mesh, shard._replace(hi=shard.hi + 1), cfg))]

        # phase 2: 3 straight MPC ticks against 2 ticks, a per-rank
        # checkpoint of the carry, a restart from it and 1 more tick
        pl, ul = shard.data[0], shard.data[2]
        x0 = distributed.scatter_local(mesh, xb[lo:hi, 0]).data
        straight = mpc.mpc_run(sys_, pl, cfg, x0, ul, 3)
        part1 = mpc.mpc_run(sys_, pl, cfg, x0, ul, 2)
        path = os.path.join(out_dir, f"mpc_carry_p{rank}.npz")
        np.savez(path, **{k: v.numpy()
                          for k, v in part1.final._asdict().items()})
        with np.load(path) as saved:
            carry = mpc.MpcCarry(**{
                k: distributed.scatter_local(mesh, saved[k]).data
                for k in mpc.MpcCarry._fields})
        resumed = mpc.mpc_run(sys_, pl, cfg, None, ul, 1, resume_from=carry)
        mpc_match = bool(np.allclose(straight.X_applied[:, 3].numpy(),
                                     resumed.X_applied[:, 1].numpy(),
                                     rtol=1e-10, atol=1e-12))
    finally:
        distributed.shutdown()

    # ``torchrun -m dcol_tpu_torch.parallel.distributed``, as torchrun
    # starts it: a process per rank with RANK, WORLD_SIZE, LOCAL_RANK and
    # the rendezvous address in its environment
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port2))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        distributed.main(["--system", "piano_mover", "--batch", "2",
                          "--device", "cpu"])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rows": [shard.lo, shard.hi], "n": shard.n_global,
                   "metrics": metrics, "X": st.X.tolist(),
                   "J": st.J.tolist(), "mismatch_raises": mismatch,
                   "mpc_resume_matches_straight": mpc_match,
                   "main_stdout": out.getvalue()}, f)


def test_two_process_gloo_solve(tmp_path):
    """Both ranks reduce the same metrics; the stitched X and J match the
    JAX package's solve_batch at rtol 1e-8 (tests/test_distributed.py:
    59-74); each rank's resumed MPC tick equals 3 straight ticks at rtol
    1e-10; a shard that does not fit the mesh raises; the entry point's
    rank 0 prints the reduced metrics of its whole batch."""
    ctx = mp.spawn(_worker, args=(_free_port(), _free_port(), str(tmp_path)),
                   nprocs=WORLD, join=False)
    # the reference, computed while the two processes run
    from dcol_tpu.parallel.batch import perturb_scenarios, solve_batch
    from dcol_tpu.systems import piano_mover

    jsys, jparams, jX0, jU0, jcfg = piano_mover.make_problem(N=N)
    jcfg = dataclasses.replace(jcfg, max_iters=MAX_ITERS)
    jp, jx, ju = perturb_scenarios(jparams, jX0, jU0, n=PER_RANK * WORLD,
                                   seed=3, x0_sigma=0.05)
    jst = solve_batch(jsys, jp, jcfg, jx, ju)
    jX, jJ = np.asarray(jst.X), np.asarray(jst.J)
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail("the two processes did not finish in 300 s")

    res = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(WORLD)]
    assert [r["rows"] for r in res] == [[0, 2], [2, 4]]
    assert all(r["n"] == 4 for r in res)
    assert res[0]["metrics"] == res[1]["metrics"]
    assert res[0]["metrics"]["n"] == 4
    X = np.concatenate([np.asarray(r["X"]) for r in res])
    J = np.concatenate([np.asarray(r["J"]) for r in res])
    np.testing.assert_allclose(X, jX, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(J, jJ, rtol=1e-8)
    for r in res:
        assert r["mpc_resume_matches_straight"]
        assert r["mismatch_raises"] == [True, True, True]
    assert "2 piano_mover scenarios over 2 processes (cpu)" in \
        res[0]["main_stdout"]
    assert "'n': 2, 'n_converged': 2," in res[0]["main_stdout"]
    assert res[1]["main_stdout"] == ""


def test_nccl_needs_cuda():
    """A CUDA device without CUDA raises before any process group starts:
    nothing moves to the CPU behind the caller's back."""
    from dcol_tpu_torch.parallel import distributed

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="NCCL needs CUDA"):
        distributed.initialize("localhost:1", 1, 0, "cuda")
