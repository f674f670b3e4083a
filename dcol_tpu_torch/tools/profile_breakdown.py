"""Component times of one batched ALTRO iteration on the card.  Port of
``tools/profile_breakdown.py``.

    python -m dcol_tpu_torch.tools.profile_breakdown [batch]

The f32 quadrotor (N=100, 11 obstacles) at ``batch`` scenarios (64 by
default) of ``perturb_scenarios(seed=0, x0_sigma=0.02)`` is advanced 10 AL
iterations to a mid-solve state.  Each component then runs alone, timed
with CUDA events over ``reps`` calls after a warm-up
(``roofline.time_launch``: the card's timeline, host gaps included):

  * ``full_iteration``: ``altro_iteration``;
  * ``backward_pass`` (Jacobians, polish PDIP batch, envelope gradients,
    Riccati) and ``forward_pass`` (rollouts and line-search PDIP batches);
  * ``constraints_solve_warm`` / ``_cold``: ``constraints_x_traj`` with and
    without the stored warm start; ``constraints_vg_warm``:
    ``constraints_x_vg_traj``;
  * ``envelope_grads_only``: ``CollisionScene._envelope_grads`` on the
    stored solution (no PDIP solve);
  * ``rollout_1alpha``: one closed-loop rollout at alpha = 1;
  * ``dynamics_jacobians``.

The components overlap (the full iteration holds the others), so they do
not sum to ``full_iteration``.  Each one's peak of allocated device memory
(``torch.cuda.max_memory_allocated`` over one call, the state it reads
included) is given beside its time.  Then one ``full_iteration`` runs under
``torch.profiler`` (:func:`dcol_tpu_torch.utils.trace.trace`): its device
busy share is the summed time of the card's kernels, copies and sets over
the window's wall, and the 10 device operations with the most time are
listed by name.  The profiler slows the host far more than the card, so
the same device time is also given over the unprofiled ``full_iteration``.

Needs a CUDA device and raises without one.  The component callables
(:func:`components`) are plain functions, so they run on the CPU too.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time

import torch

from dcol_tpu_torch.ops import nvcc_build
from dcol_tpu_torch.tools import roofline
from dcol_tpu_torch.utils import trace

ADVANCE_ITERS = 10
REPS = 5
TOP_OPS = 10
LOG_DIR = os.path.join(nvcc_build.BUILD_DIR, "profile_breakdown")


def setup(batch: int, device, N: int = 100,
          advance_iters: int = ADVANCE_ITERS):
    """(sys, params_b, cfg, state): the f32 quadrotor batch advanced
    ``advance_iters`` AL iterations."""
    from dcol_tpu_torch.parallel.batch import perturb_scenarios
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import quadrotor

    sys_, params, X0, U0, cfg = quadrotor.make_problem(torch.float32, device,
                                                       N=N)
    params_b, X0_b, U0_b = perturb_scenarios(params, X0, U0, n=batch, seed=0,
                                             x0_sigma=0.02)
    st = altro.make_initial_state(sys_, params_b, cfg, X0_b, U0_b)
    for _ in range(advance_iters):
        st = altro.altro_iteration(sys_, params_b, cfg, st)
    return sys_, params_b, cfg, st


def components(sys_, params_b, cfg, st) -> dict:
    """name -> zero-argument callable of each component at state ``st``."""
    from dcol_tpu_torch.solver import altro

    K, k, _, _ = altro.backward_pass(sys_, params_b, st.X, st.U, st.mu,
                                     st.mux, st.lambd, st.rho, st.reg,
                                     warm=st.warm)
    S, T = st.X.shape[:2]
    rs, ps = sys_.robot_pose(st.X)
    xs = tuple(x.reshape(S, T, -1, x.shape[-1]) for x, _, _ in st.warm)
    zs = tuple(z.reshape(S, T, -1, z.shape[-1]) for _, _, z in st.warm)
    one = torch.ones((S, 1), dtype=st.X.dtype, device=st.X.device)
    return {
        "full_iteration": lambda: altro.altro_iteration(sys_, params_b, cfg,
                                                        st),
        "backward_pass": lambda: altro.backward_pass(
            sys_, params_b, st.X, st.U, st.mu, st.mux, st.lambd, st.rho,
            st.reg, warm=st.warm),
        "forward_pass": lambda: altro.forward_pass(
            sys_, params_b, cfg, st.X, st.U, K, k, st.mu, st.mux, st.lambd,
            st.rho, st.hx, st.hu, st.warm),
        "constraints_solve_warm": lambda: sys_.constraints_x_traj(
            params_b, st.X, warm=st.warm)[0],
        "constraints_solve_cold": lambda: sys_.constraints_x_traj(
            params_b, st.X)[0],
        "constraints_vg_warm": lambda: sys_.constraints_x_vg_traj(
            params_b, st.X, warm=st.warm)[:2],
        "envelope_grads_only": lambda: sys_.scene._envelope_grads(
            rs, ps, params_b["obs_r"], params_b["obs_p"], xs, zs),
        "rollout_1alpha": lambda: altro.rollout(sys_, params_b, st.X, st.U,
                                                K, k, one),
        "dynamics_jacobians": lambda: altro.dynamics_jacobians(
            sys_, params_b, st.X[:, :-1], st.U),
    }


def peak_bytes(fn) -> int:
    """``torch.cuda.max_memory_allocated`` over one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def device_profile(fn, log_dir: str = LOG_DIR) -> dict:
    """One call of ``fn`` under the profiler: wall, summed device time,
    busy share and the top device operations by time."""
    with trace.trace(log_dir):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(log_dir, trace.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS:
            by_name[e["name"]][0] += e["dur"] / 1e3
            by_name[e["name"]][1] += 1
    device_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "device_ops": sum(n for _, n in by_name.values()),
            "top_ops": [{"name": name, "ms": ms, "calls": n}
                        for name, (ms, n) in top]}


def run(batch: int = 64, device="cuda", reps: int = REPS, out=print) -> dict:
    """The breakdown on ``device``; prints a table with ``out``."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_breakdown times the card: torch.cuda is "
                           "not available")
    sys_, params_b, cfg, st = setup(batch, device)
    comps = components(sys_, params_b, cfg, st)
    times = {name: roofline.time_launch(fn, reps)[0]
             for name, fn in comps.items()}
    peaks = {name: peak_bytes(fn) for name, fn in comps.items()}
    prof = device_profile(comps["full_iteration"])
    # the profiler slows the host's launches far more than the card's
    # kernels: the device time over the unprofiled iteration estimates the
    # busy share without the profiler
    prof["busy_share_unprofiled"] = prof["device_ms"] / times["full_iteration"]
    out(f"== breakdown at batch {batch}, after {ADVANCE_ITERS} AL iterations "
        f"(ms per call, CUDA events over {reps} calls; components timed "
        "alone overlap and do not sum to full_iteration) ==")
    for name, ms in times.items():
        out(f"  {name:26s} {ms:10.3f} ms  peak {peaks[name] / 2**20:9.1f} "
            "MiB allocated")
    out(f"  one full_iteration under torch.profiler: {prof['wall_ms']:.3f} "
        f"ms wall, {prof['device_ms']:.3f} ms on the card in "
        f"{prof['device_ops']} operations: busy {100 * prof['busy_share']:.2f}"
        f"% of the wall ({100 * prof['busy_share_unprofiled']:.2f}% of the "
        "unprofiled full_iteration)")
    for op in prof["top_ops"]:
        out(f"    {op['ms']:9.3f} ms  {op['calls']:6d} x  {op['name'][:90]}")
    return {"batch": batch, "advance_iters": ADVANCE_ITERS, "reps": reps,
            "components": times, "peak_bytes": peaks,
            "full_iteration_profile": prof}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    res = run(int(argv[0]) if argv else 64)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
