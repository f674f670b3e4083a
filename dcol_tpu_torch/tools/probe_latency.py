"""Single-solve (batch-1) latency on the card.  Port of
``tools/probe_latency.py``.

    python -m dcol_tpu_torch.tools.probe_latency

The f32 quadrotor (N=100, 11 obstacles, 7 exact obstacle groups, so 7 PDIP
launches per constraint batch).  One untimed solve of
``perturb_scenarios(n=1, seed=9, x0_sigma=0.02)`` through ``solve_single``
builds the kernels; then 5 solves at seeds 10-14 are timed on the host
clock, each from a CUDA sync to a sync.  Printed: the p50 and every
latency, each solve's ALTRO iterations and converged flag, and its PDIP
launches (``pdip_cuda.tally``) with the constraint batches they make up.
The last line is the result as JSON.

The JAX tool also times latency mode (``merge_groups``: one padded launch
per constraint batch).  The port does not have it: on the H100 it bought
nothing beyond the host clock's spread (PERF.md, Findings).  The JAX tool's
``xla`` configurations select its plain solver on the accelerator; the port
dispatches by device and never runs the plain version on the card.

Needs a CUDA device and raises without one.  :func:`problem`,
:func:`scenario`, :func:`solve_one` and :func:`batches` are plain
functions, so they run on the CPU too.
"""

from __future__ import annotations

import collections
import json
import statistics
import time

import torch

REPS = 5
WARM_SEED = 9     # the untimed first solve
FIRST_SEED = 10   # the timed solves: seeds 10 .. 10 + REPS - 1


def problem(device="cuda", N: int = 100):
    """(sys, params, X0, U0, cfg) of the f32 quadrotor."""
    from dcol_tpu_torch.systems import quadrotor

    return quadrotor.make_problem(torch.float32, device, N=N)


def scenario(prob, seed: int):
    """(params, x0 trajectory, U0) of ``perturb_scenarios(n=1, seed,
    x0_sigma=0.02)`` without the scenario dim."""
    from dcol_tpu_torch.parallel.batch import perturb_scenarios

    _, params, X0, U0, _ = prob
    p1, x1, u1 = perturb_scenarios(params, X0, U0, n=1, seed=seed,
                                   x0_sigma=0.02)
    return {k: v[0] for k, v in p1.items()}, x1[0], u1[0]


def solve_one(prob, scen):
    """One solve of scenario ``scen`` through ``solve_single``."""
    from dcol_tpu_torch.parallel.batch import solve_single

    sys_, _, _, _, cfg = prob
    return solve_single(sys_, scen[0], cfg, scen[1], scen[2])


def batches(tally, scene) -> dict:
    """The constraint batches that PDIP launches ``tally`` (the wrapper's
    counter, keyed (B, nv, n_ort, s1, s2, start)) make up for ``scene``:
    every batch launches each of the scene's group layouts once, so each
    layout must have the same count.  Raises ValueError otherwise."""
    by_layout = collections.Counter()
    for (_, nv, n_ort, s1, s2, _), n in tally.items():
        by_layout[(nv, n_ort, s1, s2)] += n
    want = {(lay.nv, lay.n_ort, lay.s1, lay.s2) for lay, _ in scene.groups}
    counts = set(by_layout.values())
    if set(by_layout) != want or len(counts) != 1:
        raise ValueError(f"PDIP launches by layout {dict(by_layout)} do not "
                         f"make whole constraint batches of layouts {want}")
    n_batches = counts.pop()
    return {"launches": sum(by_layout.values()), "batches": n_batches,
            "launches_per_batch": len(want)}


def measure() -> dict:
    """The latency of ``REPS`` batch-1 solves on the card."""
    from dcol_tpu_torch.ops import pdip_cuda

    if not torch.cuda.is_available():
        raise RuntimeError("probe_latency times the card: torch.cuda is not "
                           "available")
    prob = problem()
    scene = prob[0].scene

    def timed(seed):
        scen = scenario(prob, seed)
        pdip_cuda.tally.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = solve_one(prob, scen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"seed": seed, "latency_s": wall, "iters": int(st.iter),
                "converged": bool(st.converged),
                **batches(pdip_cuda.tally, scene)}

    first = timed(WARM_SEED)
    print(f"first solve (kernel builds included) {first['latency_s']:.3f} s, "
          f"{first['iters']} iterations, converged {first['converged']}",
          flush=True)
    rows = [timed(FIRST_SEED + r) for r in range(REPS)]
    lats = [r["latency_s"] for r in rows]
    p50 = statistics.median(lats)
    print(f"p50 {p50 * 1e3:.1f} ms over {REPS} solves (all: "
          f"{[round(v * 1e3, 1) for v in lats]} ms)")
    for r in rows:
        print(f"  seed {r['seed']}: {r['latency_s'] * 1e3:.1f} ms, "
              f"{r['iters']} iterations, converged {r['converged']}, "
              f"{r['launches']} PDIP launches = {r['batches']} constraint "
              f"batches x {r['launches_per_batch']}", flush=True)
    return {"p50_s": p50, "first": first, "solves": rows}


def main():
    res = dict(measure(), device=torch.cuda.get_device_name(0))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
