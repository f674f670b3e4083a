"""Hard lanes of the PDIP kernel on the card: near-contact problems, where
float32 rounding decides whether a lane converges (which is why the kernel
iterates float32 problems with a second-order-cone block in float64).

    python -m dcol_tpu_torch.tools.hard_lanes [--capture DIR]
    python -m dcol_tpu_torch.tools.hard_lanes --system SYSTEM
        [--dtype {float32,float64}] [--seeds 1-6] [--scenarios N]
        [--sigma S] [--capture DIR]
    python -m dcol_tpu_torch.tools.hard_lanes --system SYSTEM --latency
        [--dtype ...] [--seeds 9-14] [--capture DIR]
    python -m dcol_tpu_torch.tools.hard_lanes --mpc [--capture DIR]

Without any of ``--system``, ``--dtype``, ``--seeds``, ``--scenarios``,
``--sigma``, ``--latency`` or ``--mpc``, three
measurements, each of the kernel against its plain PyTorch version on the
same card, judged lane by lane by :func:`judge` (a float32 batch the
kernel iterates in float64 also against plain in float64):

1. the near-contact fixture ``tests/torch_fixtures/pdip_near_contact_f32.npz``
   (a cold batch of the f32 quadrotor's obstacle group (1, 7) at the solved
   trajectory of ``chip_smoke.py``'s latency scenario, B = 200, as the card
   computed it): its far lane's trace by ``max_iters`` (:func:`trace`), the
   kernel alone (B = 1) and in its place in the batch;
2. near-contact batches of the main path: one batch-128 f32 quadrotor
   ``solve_batch``, then the 7 obstacle groups' cold constraint batches at
   the solved trajectories and at the midpoints of the initial and solved
   ones (14 launches, 281,600 problems); per batch, the converged counts,
   the lanes that end far from tol (mu >= 10 tol) in one version only and
   the rule's failing lanes.  ``--capture DIR`` writes each lane that ends
   far in the kernel only to ``DIR`` (:func:`capture`);
3. the captured lanes ``tests/torch_fixtures/pdip_hard_lane_*.npz``: the
   kernel on each, alone and in its warp, judged by the rule; and the same
   on the open lanes ``pdip_open_lane_*.npz`` (none at present), lanes the
   kernel is known to stop far on (ROADMAP Queue C), reported and not
   gated.

With ``--system`` and the like, a run over seeds (:func:`run_seeds`): at
each seed one ``solve_batch`` of the system's ``perturb_scenarios(n, seed,
x0_sigma=sigma)`` in that dtype (``--scenarios``, ``--sigma``; sigma 0 is
the nominal problem replicated), through the kernel, with its converged
count, iterations, cold re-check, PDIP launches and wall; a batch that a
benchmark script runs is held to that script's guards (:func:`guards`:
the batch-128 f32 quadrotor of ``bench.py``, the f32 piano's and cone's
batches of 64 of ``benchmarks/bench_systems.py``).  With ``--latency``,
each seed's one scenario ``probe_latency.scenario`` through
``solve_single``, as ``bench.py`` times it, held to converging and the
cold re-check.  Then that solve's near-contact batches, judged as in 2.
Defaults: the quadrotor, float32, seed 0; the scenario count and ALTRO
cap are :data:`RUNS`'s, sigma RUNS' with its count, else 0.02
(:func:`run_shape`).  ``--mpc``: ``chip_smoke.py`` phase 8's
closed-loop quadrotor for ``bench_mpc.py``'s 10 ticks, and the cold
constraint batches at its measured states (:func:`judge_mpc`).  Exits 1
if a guard or the rule fails.

To measure another checkout's kernel (an unpacked ``git archive`` of the
parent, say), run this file from that checkout's root with it first on the
path, ``PYTHONPATH=. python <this checkout>/dcol_tpu_torch/tools/hard_lanes.py``:
the fixtures are this checkout's, the batches come from that checkout's own
solve.  Needs a CUDA device and raises without one; the record goes to
``dcol_tpu_torch/build/hard_lanes.json`` (a run over seeds:
``hard_lanes_<system>_<dtype>_<scenarios>x<sigma>.json`` or
``..._latency.json``; ``--mpc``: ``hard_lanes_mpc.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "torch_fixtures")
FIXTURE = os.path.join(FIXTURES, "pdip_near_contact_f32.npz")
CAPTURED = "pdip_hard_lane_*.npz"
OPEN = "pdip_open_lane_*.npz"
BORDER = 10  # a lane that ends at mu >= BORDER x tol stopped far from tol
# the rule's alpha floor, relative to 1 + |alpha of the f64 solve|
ALPHA_ATOL = 1e-4
# a lane far from tol in the plain version only: both versions' alpha
# within FAR_ALPHA_TOL x (1 + |alpha of the f64 solve|)
FAR_ALPHA_TOL = 2e-3
F64_KW = dict(tol=1e-9, max_iters=40)  # the reference solve of a lane
WARP = 32
# a float64 kernel may converge this share of a batch's lanes fewer than
# its plain version
COUNT_SLACK = 1e-3
# the systems, by their CLI names: the scenario count, x0_sigma and ALTRO
# cap (None: the system's own) of a run over seeds.  The piano's is its
# nominal problem (sigma 0: perturb_scenarios adds exact zeros).  Some
# perturbed f32 cone scenarios iterate past 1,000 ALTRO iterations without
# failing, so the cone's batch is capped, in both dtypes, as
# chip_smoke.py's phase 7 caps its f32 batch
CONE_MAX_ITERS = 80
PERTURB_SIGMA = 0.02  # bench.py's and bench_systems.py's x0_sigma
RUNS = {"quadrotor": (128, PERTURB_SIGMA, None),
        "piano_mover": (1, 0.0, None),
        "coneThroughWall": (32, PERTURB_SIGMA, CONE_MAX_ITERS)}
# the benchmarks' guards: every scenario converged, finite, and converged
# trajectories that reach the goal without collision by a cold re-check;
# the main path (bench.py) also a mean of ALTRO iterations in the JAX f32
# band
MAIN_ITERS = (44.0, 55.0)
MAIN_H_TOL = MAIN_GOAL_TOL = 1e-3
# the JAX package's mean ALTRO iterations of the batch-128 f32 quadrotor at
# bench.py's seeds (BENCH_r05.json, printed to one decimal)
JAX_MEAN_ITERS = {1: 47.6, 2: 47.7, 3: 47.5, 4: 47.5, 5: 47.7, 6: 47.5}
# benchmarks/bench_systems.py's f32 batches of 64: the piano perturbed at
# x0_sigma 0.02 (seed 0, then seeds 1-6), the cone's nominal problem
# replicated (sigma 0)
SYSTEMS_BATCH = 64
PIANO_SIGMA, CONE_SIGMA = PERTURB_SIGMA, 0.0
# the JAX package's piano means at its timed seeds 2-6
# (benchmarks/systems_r05b_raw.log, reps 0-4, one decimal; rep r is seed
# r + 2); the port's must lie within PIANO_JAX_ATOL of each, and in
# PIANO_ITERS at seeds 0-1 (the JAX script's untimed solves)
PIANO_JAX_MEAN_ITERS = {2: 36.5, 3: 36.8, 4: 36.2, 5: 36.4, 6: 36.3}
PIANO_JAX_ATOL = 0.5
PIANO_ITERS = (34.0, 39.0)
# the JAX package's cone batch: 64/64 in 50.0 at every rep (same log);
# printed beside the port's, not gated (the kernel iterates it in f64)
CONE_JAX_MEAN_ITERS = 50.0
# chip_smoke.py phase 8's closed loop, the f32 quadrotor of
# benchmarks/bench_mpc.py: S scenarios from default_rng(0), horizon N, at
# most TICK_ITERS ALTRO iterations a tick; bench_mpc.py's default of
# MPC_STEPS ticks (the smoke runs 5)
MPC_S, MPC_N, MPC_TICK_ITERS, MPC_STEPS = 128, 40, 8, 10


def load_fixture(device) -> Dict:
    """The fixture's batch on ``device``, its cone layout, settings and far
    lane."""
    from dcol_tpu_torch.ops.cones import ConeLayout

    f = np.load(FIXTURE)
    return {"c": torch.as_tensor(f["c"], device=device),
            "G": torch.as_tensor(f["G"], device=device),
            "h": torch.as_tensor(f["h"], device=device),
            "lay": ConeLayout(*(int(v) for v in f["layout"])),
            "kw": dict(tol=float(f["tol"]), max_iters=int(f["max_iters"]),
                       jitter=float(f["jitter"])),
            "lane": int(f["far_lanes"][0])}


def mu_of(sol, lay) -> torch.Tensor:
    """Each problem's final mu = s.z / degree, in float64."""
    return (sol.s.double() * sol.z).sum(-1) / lay.degree


def lanes_of(sol, lay) -> Dict:
    """What the rule reads of a solve: converged flags, mu and alpha =
    x[3], on the CPU."""
    return {"converged": sol.converged.cpu(), "mu": mu_of(sol, lay).cpu(),
            "alpha": sol.x[:, 3].cpu()}


def judge_lanes(kernel: Dict, plain: Dict, lay, problems, tol: float,
                skip: Optional[torch.Tensor] = None) -> Dict:
    """The per-lane rule of a float32 kernel against its plain version.

    ``kernel`` and ``plain`` are :func:`lanes_of` one batch ``problems`` =
    (c, G, h); ``skip`` marks lanes neither version solved (they are held
    bitwise elsewhere).  A lane is disputed if the converged flags differ or
    either version ends at mu >= tol.  Each disputed lane is solved by the
    plain version in float64 (tol 1e-9, 40 iterations), which must converge,
    and the kernel fails it if

    (a) it ends far from tol (mu >= BORDER tol) where plain does not, or
    (b) |alpha_k - alpha64| > max(2 |alpha_p - alpha64|,
        ALPHA_ATOL (1 + |alpha64|));

    a lane far in the plain version only fails unless both alphas lie
    within FAR_ALPHA_TOL (1 + |alpha64|) of alpha64.  Where the two end
    near tol is rounding; what ALTRO reads is alpha, and a stop far from
    tol where the reference converges.  Returns the count of disputed lanes
    and a row for each lane that is far in one version or fails."""
    from dcol_tpu_torch.ops.pdip import solve_socp

    k, p = ({n: t.cpu() for n, t in d.items()} for d in (kernel, plain))
    settled = (k["converged"] & p["converged"] & (k["mu"] < tol)
               & (p["mu"] < tol))
    if skip is not None:
        settled = settled | skip.cpu()
    idx = (~settled).nonzero()[:, 0]
    out = {"disputed": len(idx), "lanes": [], "failing": [],
           "kernel_only_far": [], "plain_only_far": []}
    if not len(idx):
        return out
    dev = problems[0].device
    r64 = solve_socp(*(a[idx.to(dev)].double() for a in problems), lay,
                     **F64_KW)
    conv64, a64 = r64.converged.cpu(), r64.x[:, 3].cpu()
    mk, mp = k["mu"][idx], p["mu"][idx]
    e_k = (k["alpha"][idx].double() - a64).abs()
    e_p = (p["alpha"][idx].double() - a64).abs()
    bd = BORDER * tol
    far_k, far_p = ~(mk < bd), ~(mp < bd)  # a NaN mu is far
    scale = 1 + a64.abs()
    fails = {
        "f64 solve not converged": ~conv64,
        "far in the kernel only": far_k & ~far_p,
        "alpha": ~(e_k <= torch.maximum(2 * e_p, ALPHA_ATOL * scale)),
        "plain-only far lane's alpha": far_p & ~far_k & ~(
            torch.maximum(e_k, e_p) <= FAR_ALPHA_TOL * scale)}
    show = far_k ^ far_p
    for m in fails.values():
        show = show | m
    for j in show.nonzero()[:, 0].tolist():
        lane = int(idx[j])
        row = {"lane": lane, "mu_kernel": float(mk[j]),
               "mu_plain": float(mp[j]), "alpha_f64": float(a64[j]),
               "err_kernel_f64": float(e_k[j]),
               "err_plain_f64": float(e_p[j]),
               "fails": [n for n, m in fails.items() if bool(m[j])]}
        out["lanes"].append(row)
        if row["fails"]:
            out["failing"].append(lane)
        if bool(far_k[j] & ~far_p[j]):
            out["kernel_only_far"].append(lane)
        if bool(far_p[j] & ~far_k[j]):
            out["plain_only_far"].append(lane)
    return out


def judge_f64(kernel: Dict, plain: Dict, lay, problems, tol: float,
              skip: Optional[torch.Tensor] = None) -> Dict:
    """The rule of a kernel that iterates in float64 against its plain
    version in float64, on :func:`lanes_of` one batch ``problems`` = (c, G,
    h); ``skip`` marks lanes neither version solved, which are not judged.

    First the count rule: the kernel converges no fewer lanes than plain,
    COUNT_SLACK of the batch slack (``count_short`` if it does).  Then the
    far lanes: those whose flags differ with either version far from tol
    (mu >= BORDER tol), and those far in the kernel only, each solved in
    float64 (tol 1e-9, 40 iterations), which must converge.  The kernel
    fails a lane it ends far on, and a lane far in the plain version only
    whose alphas miss the f64 solve's by more than FAR_ALPHA_TOL (1 +
    |alpha64|).  The record of :func:`judge_lanes`, with ``count_short``."""
    from dcol_tpu_torch.ops.pdip import solve_socp

    k, p = ({n: t.cpu() for n, t in d.items()} for d in (kernel, plain))
    live = (torch.ones_like(k["converged"]) if skip is None
            else ~skip.cpu().expand(k["converged"].shape))
    B = int(live.sum())
    n_k = int((k["converged"] & live).sum())
    n_p = int((p["converged"] & live).sum())
    bd = BORDER * tol
    near_k, near_p = k["mu"] < bd, p["mu"] < bd  # a NaN mu is far
    far = live & (((k["converged"] != p["converged"]) & ~(near_k & near_p))
                  | (near_p & ~near_k))
    idx = far.nonzero()[:, 0]
    out = {"disputed": len(idx), "count_short": n_k < n_p - COUNT_SLACK * B,
           "lanes": [], "failing": [], "kernel_only_far": [],
           "plain_only_far": []}
    if not len(idx):
        return out
    dev = problems[0].device
    r64 = solve_socp(*(a[idx.to(dev)].double() for a in problems), lay,
                     **F64_KW)
    conv64, a64 = r64.converged.cpu(), r64.x[:, 3].cpu()
    e_k = (k["alpha"][idx].double() - a64).abs()
    e_p = (p["alpha"][idx].double() - a64).abs()
    nk, np_ = near_k[idx], near_p[idx]
    fails = {
        "f64 solve not converged": ~conv64,
        "far in the kernel": ~nk,
        "plain-only far lane's alpha": nk & ~(
            torch.maximum(e_k, e_p) <= FAR_ALPHA_TOL * (1 + a64.abs()))}
    for j, lane in enumerate(idx.tolist()):
        row = {"lane": lane, "mu_kernel": float(k["mu"][lane]),
               "mu_plain": float(p["mu"][lane]), "alpha_f64": float(a64[j]),
               "err_kernel_f64": float(e_k[j]),
               "err_plain_f64": float(e_p[j]),
               "fails": [n for n, m in fails.items() if bool(m[j])]}
        out["lanes"].append(row)
        if row["fails"]:
            out["failing"].append(lane)
        if bool(np_[j] & ~nk[j]):
            out["kernel_only_far"].append(lane)
        if bool(nk[j] & ~np_[j]):
            out["plain_only_far"].append(lane)
    return out


def iterates_in_f64(dtype, lay) -> bool:
    """Whether the kernel iterates a ``dtype`` batch of layout ``lay`` in
    float64 from float32 operands (``pdip_cuda.arith_dtype``)."""
    from dcol_tpu_torch.ops import pdip_cuda

    return pdip_cuda.arith_dtype(dtype, lay) != dtype


def plain_f64(problems, lay, kw: Dict, warm=None,
              skip: Optional[torch.Tensor] = None) -> Dict:
    """:func:`lanes_of` the plain version run in float64 on the inputs
    widened to float64 (``problems`` = (c, G, h), the warm start if any),
    with the batch's settings ``kw``: what the kernel computes on a float32
    batch it iterates in float64, but for where the warm start is
    rounded."""
    from dcol_tpu_torch.ops.pdip import solve_socp

    wide = lambda arrs: tuple(a.double() for a in arrs)
    return lanes_of(solve_socp(*wide(problems), lay,
                               warm=None if warm is None else wide(warm),
                               skip=skip, **kw), lay)


def judge(kernel: Dict, plain: Dict, lay, problems, kw: Dict, warm=None,
          skip: Optional[torch.Tensor] = None,
          at: Optional[int] = None) -> Dict:
    """The kernel against its plain version on one batch ``problems`` =
    (c, G, h), solved by both with the settings ``kw`` and the warm start
    ``warm`` if any, by the rule of what the kernel computes; ``skip``'s
    lanes are not judged (they are held bitwise elsewhere).  With ``at``,
    only that lane of the batch is judged.

    - float64: :func:`judge_f64` against plain;
    - float32 iterated in float32 (no SOC block): :func:`judge_lanes`
      against plain (``count_short`` is then False: no count is a rule
      there);
    - float32 iterated in float64 (an SOC block, :func:`iterates_in_f64`):
      both.  :func:`judge_lanes` against plain float32 ties the kernel to
      the JAX package's float32 semantics; :func:`judge_f64` against plain
      in float64 on the widened inputs (:func:`plain_f64`, run here on the
      whole batch) holds it to what it now computes.  The record is
      judge_lanes', with the f64 rule's record under ``f64``, its rows
      (tagged ``rule``) added to ``lanes``, ``failing`` and
      ``kernel_only_far`` the union of both rules', ``count_short`` the f64
      rule's and ``conv_plain64`` plain float64's converged count."""
    tol = kw["tol"]
    p64 = (plain_f64(problems, lay, kw, warm=warm, skip=skip)
           if iterates_in_f64(problems[0].dtype, lay) else None)
    if at is not None:
        one = lambda d: None if d is None else {n: t[at:at + 1]
                                                for n, t in d.items()}
        kernel, plain, p64 = one(kernel), one(plain), one(p64)
        problems = tuple(a[at:at + 1] for a in problems)
        skip = None if skip is None else skip[at:at + 1]
    if problems[0].dtype != torch.float32:
        return judge_f64(kernel, plain, lay, problems, tol, skip=skip)
    v = dict(judge_lanes(kernel, plain, lay, problems, tol, skip=skip),
             count_short=False)
    if p64 is None:
        return v
    w = judge_f64(kernel, p64, lay, problems, tol, skip=skip)
    union = lambda key: sorted(set(v[key]) | set(w[key]))
    return dict(v, f64=w, failing=union("failing"),
                kernel_only_far=union("kernel_only_far"),
                count_short=w["count_short"],
                conv_plain64=int(p64["converged"].sum()),
                lanes=v["lanes"] + [dict(r, rule="f64") for r in w["lanes"]])


def describe_lane(row) -> str:
    return (("f64 rule " if row.get("rule") == "f64" else "")
            + f"lane {row['lane']}: mu kernel {row['mu_kernel']:.3e}, plain "
            f"{row['mu_plain']:.3e}; |alpha - f64| kernel "
            f"{row['err_kernel_f64']:.3e}, plain {row['err_plain_f64']:.3e}"
            + (f"; fails: {', '.join(row['fails'])}" if row["fails"] else ""))


def trace(solve, c, G, h, lay, kw, lane) -> List[Tuple[int, int, float]]:
    """(k, steps, mu) of one lane for max_iters = k = 1 .. kw["max_iters"].
    The solver is deterministic, so each run repeats the one before and
    takes at most one more step: fewer steps than k with mu >= tol means
    the lane froze on a non-finite candidate at step steps + 1."""
    rows = []
    for k in range(1, kw["max_iters"] + 1):
        o = solve(c, G, h, lay, **dict(kw, max_iters=k))
        rows.append((k, int(o.iters[lane]), float(mu_of(o, lay)[lane])))
    return rows


def trace_end(rows, tol) -> str:
    """How a traced lane ends: converged; froze on a non-finite candidate;
    or stalled at the cap."""
    k, it, mu = rows[-1]
    if mu < tol:
        return f"converged in {it} steps (mu {mu:.3e})"
    if it < k:
        return f"froze on a non-finite step {it + 1} at mu {mu:.3e}"
    return f"stalled at mu {mu:.3e} after {it} steps"


def fixture_traces(solve, fx) -> Dict:
    """The far lane's trace through ``solve``, alone and in place."""
    c, G, h, lay, kw, lane = (fx[k] for k in ("c", "G", "h", "lay", "kw",
                                               "lane"))
    one = tuple(a[lane:lane + 1].contiguous() for a in (c, G, h))
    out = {}
    for where, args, i in (("alone", one, 0), ("in place", (c, G, h), lane)):
        rows = trace(solve, *args, lay, kw, i)
        out[where] = {"rows": rows, "end": trace_end(rows, kw["tol"])}
    return out


def system_module(system: str):
    """The module of a system by its CLI name (:data:`RUNS`)."""
    from dcol_tpu_torch.systems import (
        cone_through_wall, piano_mover, quadrotor)

    mods = {"quadrotor": quadrotor, "piano_mover": piano_mover,
            "coneThroughWall": cone_through_wall}
    if system not in mods:
        raise ValueError(f"unknown system {system!r}: one of {sorted(mods)}")
    return mods[system]


def system_problem(system: str, dtype, device, *, seed: int, n: int,
                   sigma: float = PERTURB_SIGMA,
                   max_iters: Optional[int] = None, N: Optional[int] = None):
    """(system, scenario parameters, X0, U0, config) of ``n`` scenarios of
    ``system`` in ``dtype``: ``perturb_scenarios(n, seed, x0_sigma=sigma)``,
    as ``bench.py`` and ``benchmarks/bench_systems.py`` build them, for any
    n (``sigma = 0``: the nominal problem, replicated); the ALTRO cap
    ``max_iters`` and the horizon ``N`` if given."""
    from dcol_tpu_torch.parallel.batch import perturb_scenarios

    sys_, params, X0, U0, cfg = system_module(system).make_problem(
        dtype, device, **({} if N is None else {"N": N}))
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=n, seed=seed,
                                   x0_sigma=sigma)
    if max_iters is not None:
        cfg = dataclasses.replace(cfg, max_iters=max_iters)
    return sys_, pb, xb, ub, cfg


def system_state(system: str, dtype, device, *, seed: int, n: int,
                 sigma: float = PERTURB_SIGMA,
                 solved: Optional[torch.Tensor] = None,
                 max_iters: Optional[int] = None):
    """(system, scenario parameters, initial and solved trajectories) of
    :func:`system_problem`'s scenarios.  ``solved``: the solved
    trajectories, if the caller already ran the solve; else this solves
    the batch (``solve_batch``)."""
    from dcol_tpu_torch.parallel.batch import solve_batch

    sys_, pb, xb, ub, cfg = system_problem(system, dtype, device, seed=seed,
                                           n=n, sigma=sigma,
                                           max_iters=max_iters)
    if solved is None:
        solved = solve_batch(sys_, pb, cfg, xb, ub).X
    return sys_, pb, xb, solved


def solve_stats(sys_, pb, st) -> Dict:
    """What a batch solve's guards read: converged and failed counts, the
    mean and largest ALTRO iteration counts, whether X and U are finite,
    a cold re-check of the converged trajectories (max h = 1 - alpha and
    max |x_N - x_goal|; NaN if none converged), and whether every
    scenario's iterations and X equal the first's (bitwise)."""
    from dcol_tpu_torch.solver import altro

    conv = st.converged
    n_conv = int(conv.sum())
    iters = st.iter.double()
    worst = goal = float("nan")
    if n_conv:
        hx, _, _ = altro.eval_constraints(sys_, pb, st.X, st.U)
        worst = float(hx[conv].max())
        goal = float((st.X[conv, -1] - pb["Xref"][conv, -1]).abs().max())
    return {"n": int(conv.numel()), "converged": n_conv,
            "failed": int(st.failed.sum()), "mean_iters": float(iters.mean()),
            "max_iters": int(iters.max()),
            "finite": bool(torch.isfinite(st.X).all()
                           & torch.isfinite(st.U).all()),
            "max_h": worst, "goal_err": goal,
            "iters_equal": bool((st.iter == st.iter[:1]).all()),
            "X_equal": bool((st.X == st.X[:1]).all()),
            "scenarios_converged": conv.nonzero()[:, 0].tolist(),
            "iters": st.iter.tolist()}


def batch_failures(stats: Dict, band=None) -> List[str]:
    """The benchmarks' guards on :func:`solve_stats` of a batch solve: each
    guard it misses, or none.  Every scenario converged, X and U finite,
    the converged trajectories collision-free at the goal by the cold
    re-check; with ``band`` = (lo, hi), the mean ALTRO iterations in it."""
    out = []
    if stats["converged"] != stats["n"]:
        out.append(f"only {stats['converged']}/{stats['n']} converged")
    if band is not None and not band[0] <= stats["mean_iters"] <= band[1]:
        out.append(f"mean ALTRO iterations {stats['mean_iters']} outside "
                   f"{band[0]}-{band[1]}")
    if not stats["finite"]:
        out.append("non-finite states or controls")
    if not (stats["max_h"] < MAIN_H_TOL and stats["goal_err"] < MAIN_GOAL_TOL):
        out.append(f"converged trajectories collide or miss the goal (max h "
                   f"{stats['max_h']:.3e}, goal error {stats['goal_err']:.3e})")
    return out


def main_path_failures(stats: Dict) -> List[str]:
    """The main path's guards (``bench.py``): :func:`batch_failures` with
    the mean in the JAX f32 band MAIN_ITERS."""
    return batch_failures(stats, MAIN_ITERS)


def piano_failures(stats: Dict, seed: int) -> List[str]:
    """The f32 piano's batch of 64 (``bench_systems.py``):
    :func:`batch_failures` with the mean within PIANO_JAX_ATOL of the JAX
    package's at ``seed`` (seeds 2-6), else in PIANO_ITERS."""
    jax_mean = PIANO_JAX_MEAN_ITERS.get(seed)
    band = (PIANO_ITERS if jax_mean is None
            else (jax_mean - PIANO_JAX_ATOL, jax_mean + PIANO_JAX_ATOL))
    return batch_failures(stats, band)


def cone_failures(stats: Dict) -> List[str]:
    """The f32 cone's replicated batch of 64 (``bench_systems.py``):
    :func:`batch_failures`, and 64 identical problems solved in one launch
    give every member the same iterations and X bit for bit."""
    out = batch_failures(stats)
    if not stats["iters_equal"]:
        out.append("the replicated members' iterations differ")
    if not stats["X_equal"]:
        out.append("the replicated members' trajectories differ")
    return out


def guards(system: str, dtype, n: int, sigma: float, seed: int,
           stats: Dict) -> Tuple[Optional[List[str]], Optional[float]]:
    """The guards that the benchmark script running this batch (``n``
    scenarios of ``system`` in ``dtype`` at ``sigma``) holds it to, as a
    list of those it misses (None: no benchmark runs it), and the JAX
    package's mean ALTRO iterations on it at ``seed`` (None: none
    recorded)."""
    if dtype != torch.float32:
        return None, None
    key = (system, n, sigma)
    if key == ("quadrotor", RUNS["quadrotor"][0], RUNS["quadrotor"][1]):
        return main_path_failures(stats), JAX_MEAN_ITERS.get(seed)
    if key == ("piano_mover", SYSTEMS_BATCH, PIANO_SIGMA):
        return piano_failures(stats, seed), PIANO_JAX_MEAN_ITERS.get(seed)
    if key == ("coneThroughWall", SYSTEMS_BATCH, CONE_SIGMA):
        return cone_failures(stats), CONE_JAX_MEAN_ITERS
    return None, None


def constraint_batches(sys_, pb, X, tag: str) -> List[Dict]:
    """The obstacle groups' cold constraint batches at the states ``X``
    (S, T, nx), each flat (B = S T x the group's obstacles) and named
    "<tag> <group>": {"name", "nv", "lay", "c", "G", "h", "kw"}."""
    from dcol_tpu_torch.ops.cones import ConeLayout

    opts = sys_.scene.opts
    kw = dict(tol=opts.tol, max_iters=opts.max_iters, jitter=opts.jitter)
    rs, ps = sys_.robot_pose(X)
    grouped = sys_.scene.assemble_groups(rs, ps, pb["obs_r"][:, None],
                                         pb["obs_p"][:, None])
    return [{"name": f"{tag} {idx}", "nv": lay.nv,
             "lay": ConeLayout(lay.n_ort, lay.s1, lay.s2), "kw": kw,
             **{k: a.reshape((-1,) + a.shape[3:]).contiguous()
                for k, a in (("c", c), ("G", G), ("h", h))}}
            for (lay, idx), (c, G, h) in zip(sys_.scene.groups, grouped)]


def near_contact_batches(sys_, pb, xb, X) -> List[Dict]:
    """The obstacle groups' cold constraint batches at the solved
    trajectories ``X`` and at the midpoints of ``xb`` and ``X``
    (:func:`constraint_batches`)."""
    return (constraint_batches(sys_, pb, X, "solved")
            + constraint_batches(sys_, pb, 0.5 * (X + xb), "midpoint"))


def outputs(solve, batches) -> List[Dict]:
    """``solve`` on each batch: :func:`lanes_of` its solution."""
    return [lanes_of(solve(b["c"], b["G"], b["h"], b["lay"], **b["kw"]),
                     b["lay"]) for b in batches]


def compare(batches, plain, kernel) -> Dict:
    """Kernel against plain per batch: converged counts, the lanes that end
    far from tol in one version only, and the verdict of what the kernel
    computes (:func:`judge`, which also holds a float32 batch the kernel
    iterates in float64 to plain in float64)."""
    rows, tot = [], {"problems": 0, "conv_kernel": 0, "conv_plain": 0,
                     "disputed": 0, "failing": 0, "kernel_only_far": 0,
                     "plain_only_far": 0, "count_short": 0,
                     "f64_disputed": 0, "f64_failing": 0}
    for b, p, k in zip(batches, plain, kernel):
        v = judge(k, p, b["lay"], (b["c"], b["G"], b["h"]), b["kw"])
        r = {"batch": b["name"], "B": b["c"].shape[0],
             "dtype": str(b["c"].dtype)[6:],
             "conv_kernel": int(k["converged"].sum()),
             "conv_plain": int(p["converged"].sum()),
             "max_abs_err_alpha": float((k["alpha"] - p["alpha"]).abs()
                                        .max()), **v}
        if "f64" in v:
            tot["f64_disputed"] += v["f64"]["disputed"]
            tot["f64_failing"] += len(v["f64"]["failing"])
        rows.append(r)
        for key in ("conv_kernel", "conv_plain", "disputed", "count_short"):
            tot[key] += r[key]
        tot["problems"] += r["B"]
        for key in ("failing", "kernel_only_far", "plain_only_far"):
            tot[key] += len(r[key])
    return {"batches": rows, "totals": tot}


def verdict_failures(tot: Dict) -> List[str]:
    """What :func:`compare`'s totals fail: lanes failing the rule, lanes far
    from tol in the kernel only, float64 batches short of plain's count."""
    return [f"{tot[k]} {what}" for k, what in (
        ("failing", "lanes fail the rule"),
        ("kernel_only_far", "lanes far from tol in the kernel only"),
        ("count_short", "batches converge fewer lanes than plain in f64"))
        if tot[k]]


def describe_totals(tot: Dict) -> str:
    return (f"{tot['problems']:,} problems; converged kernel "
            f"{tot['conv_kernel']:,}, plain {tot['conv_plain']:,}; far from "
            f"tol in the kernel only {tot['kernel_only_far']}, in plain only "
            f"{tot['plain_only_far']}; the rule: {tot['disputed']} disputed, "
            f"{tot['failing']} failing (the f64 rule on batches iterated in "
            f"f64: {tot['f64_disputed']} disputed, {tot['f64_failing']} "
            f"failing), {tot['count_short']} batches short of plain's "
            f"count")


def capture(batches, verdicts, directory, solve) -> List[Dict]:
    """Write each lane that ends far from tol in the kernel only to
    ``directory``/pdip_hard_lane_<batch>_<lane>.npz: the problems of its
    warp (32 / team lanes, as the kernel launched them together), its index
    there, its batch's name, layout and settings, whether the kernel
    (``solve``) still stops far on it alone, and each version's mu and
    alpha with the f64 solve's alpha."""
    from dcol_tpu_torch.ops import pdip_cuda

    os.makedirs(directory, exist_ok=True)
    saved = []
    for b, v in zip(batches, verdicts):
        lay, kw, B = b["lay"], b["kw"], b["c"].shape[0]
        per_warp = WARP // pdip_cuda.team_lanes(
            lay.nr, pdip_cuda.arith_dtype(b["c"].dtype, lay))
        for lane in v["kernel_only_far"]:
            row = next(r for r in v["lanes"] if r["lane"] == lane)
            lo = lane - lane % per_warp
            warp = tuple(a[lo:min(lo + per_warp, B)].contiguous()
                         for a in (b["c"], b["G"], b["h"]))
            alone = solve(*(a[lane:lane + 1] for a in (b["c"], b["G"],
                                                        b["h"])), lay, **kw)
            mu_alone = float(mu_of(alone, lay)[0])
            path = os.path.join(directory, "pdip_hard_lane_" + re.sub(
                r"\W+", "_", b["name"]).strip("_") + f"_{lane}.npz")
            np.savez(path, **{n: a.cpu().numpy() for n, a in
                              zip(("c", "G", "h"), warp)},
                     lane=lane - lo, batch_lane=lane, batch=b["name"],
                     layout=np.array([lay.n_ort, lay.s1, lay.s2]),
                     tol=kw["tol"], jitter=kw["jitter"],
                     max_iters=kw["max_iters"], far_alone=mu_alone
                     >= BORDER * kw["tol"], mu_kernel_alone=mu_alone,
                     mu_kernel=row["mu_kernel"], mu_plain=row["mu_plain"],
                     alpha_f64=row["alpha_f64"],
                     err_kernel_f64=row["err_kernel_f64"],
                     err_plain_f64=row["err_plain_f64"])
            saved.append({"path": path, "batch": b["name"], "lane": lane,
                          "mu_kernel_alone": mu_alone, **row})
    return saved


def captured_lanes(pattern: str = CAPTURED) -> List[str]:
    """The captured lanes' files (``OPEN``: the open ones), sorted."""
    return sorted(glob.glob(os.path.join(FIXTURES, pattern)))


def load_lane(path, device) -> Dict:
    """A captured lane's warp on ``device``, its layout, settings and index
    in the warp."""
    from dcol_tpu_torch.ops.cones import ConeLayout

    f = np.load(path)
    return {"c": torch.as_tensor(f["c"], device=device),
            "G": torch.as_tensor(f["G"], device=device),
            "h": torch.as_tensor(f["h"], device=device),
            "lay": ConeLayout(*(int(v) for v in f["layout"])),
            "kw": dict(tol=float(f["tol"]), max_iters=int(f["max_iters"]),
                       jitter=float(f["jitter"])),
            "lane": int(f["lane"]), "batch": str(f["batch"]),
            "name": os.path.basename(path)[:-4]}


def judge_captured(solve, lane: Dict) -> Dict:
    """``solve`` against the plain version on a captured lane, alone (B = 1)
    and in its warp, each judged on that lane by :func:`judge` (a lane the
    kernel iterates in float64 also against plain in float64):
    {"alone": verdict, "in its warp": verdict}."""
    from dcol_tpu_torch.ops.pdip import solve_socp

    c, G, h, lay, kw, i = (lane[k] for k in ("c", "G", "h", "lay", "kw",
                                              "lane"))
    out = {}
    for where, prob, j in (
            ("alone", tuple(a[i:i + 1].contiguous() for a in (c, G, h)), 0),
            ("in its warp", (c, G, h), i)):
        got, ref = (lanes_of(s(*prob, lay, **kw), lay)
                    for s in (solve, solve_socp))
        out[where] = judge(got, ref, lay, prob, kw, at=j)
        out[where].update(mu=float(got["mu"][j]),
                          alpha=float(got["alpha"][j]))
    return out


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("hard_lanes measures the card's kernel: it needs "
                           "CUDA")
    return device


def run(device="cuda", out=print, capture_dir=None) -> Dict:
    """The three measurements of this process's kernel against the plain
    version; with ``capture_dir``, the kernel-only far lanes of the
    near-contact batches are written there (:func:`capture`)."""
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.pdip import solve_socp

    device = _card(device)
    fx = load_fixture(device)
    kernel = pdip_cuda.solve_socp_cuda
    batches = near_contact_batches(*system_state(
        "quadrotor", torch.float32, device, seed=0, n=128))
    res = {"device": torch.cuda.get_device_name(device),
           "traces": {"plain": fixture_traces(solve_socp, fx),
                      "kernel": fixture_traces(kernel, fx)},
           **compare(batches, outputs(solve_socp, batches),
                     outputs(kernel, batches)),
           **{key: {os.path.basename(p): judge_captured(
               kernel, load_lane(p, device)) for p in captured_lanes(pat)}
              for key, pat in (("captured", CAPTURED), ("open", OPEN))}}
    for name, traces in res["traces"].items():
        for where, t in traces.items():
            out(f"[hard_lanes] fixture lane {fx['lane']}, {name} {where}: "
                f"{t['end']}; (max_iters, steps, mu) "
                + " ".join(f"{k}:{it}:{mu:.2e}" for k, it, mu in t["rows"]))
    out(f"[hard_lanes] kernel on {len(batches)} near-contact batches: "
        + describe_totals(res["totals"]))
    log_lanes(res["batches"], out)
    for key in ("captured", "open"):
        for name, v in res[key].items():
            for where, w in v.items():
                out(f"[hard_lanes] {key} {name}, kernel {where}: mu "
                    f"{w['mu']:.3e}, alpha {w['alpha']:.7f}, failing "
                    f"{len(w['failing'])}" + "".join(
                        f"; {describe_lane(row)}" for row in w["lanes"]))
    if capture_dir is not None:
        res["capture"] = capture(batches, res["batches"], capture_dir,
                                 kernel)
        log_capture(res["capture"], out)
    return res


def log_lanes(rows, out):
    for r in rows:
        for row in r["lanes"]:
            out(f"[hard_lanes]   {r['batch']} B={r['B']:,} "
                + describe_lane(row))


def log_capture(saved, out):
    for s in saved:
        out(f"[hard_lanes] captured {s['batch']} lane {s['lane']} to "
            f"{s['path']}: kernel alone mu {s['mu_kernel_alone']:.3e}; "
            + describe_lane(s))


def run_shape(system: str, n: Optional[int] = None,
              sigma: Optional[float] = None) -> Tuple[int, float,
                                                       Optional[int]]:
    """(scenarios, sigma, ALTRO cap) of a run over seeds of ``system``: n
    if given, else :data:`RUNS`'s count; sigma if given, else RUNS' with
    RUNS' count (the piano's nominal problem), else PERTURB_SIGMA as the
    benchmark scripts perturb; RUNS' cap."""
    n0, sigma0, cap = RUNS[system]
    if sigma is None:
        sigma = sigma0 if n is None else PERTURB_SIGMA
    return (n0 if n is None else n), sigma, cap


def run_seeds(system: str, dtype, seeds, device="cuda", out=print,
              capture_dir=None, n: Optional[int] = None,
              sigma: Optional[float] = None, latency: bool = False) -> Dict:
    """At each seed, ``n`` scenarios of ``system`` at ``sigma``
    (:func:`system_problem`; :func:`run_shape` fills in None) solved by
    ``solve_batch`` through the kernel, or with ``latency`` the seed's one
    scenario ``probe_latency.scenario`` through ``solve_single``: converged
    count, iterations, cold re-check, PDIP launches and the host-bound
    eager wall.  A batch a benchmark script runs is held to its guards
    (:func:`guards`), a latency solve to :func:`batch_failures`.  Then
    that solve's near-contact batches, the kernel against plain
    (:func:`compare`); with ``capture_dir``, their kernel-only far lanes
    are written there.  ``failures`` lists every guard and rule missed."""
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.pdip import solve_socp
    from dcol_tpu_torch.parallel.batch import solve_batch
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.tools import probe_latency

    mod = system_module(system)
    device = _card(device)
    if latency:
        n, sigma, cap = 1, None, None
        prob = mod.make_problem(dtype, device)
    else:
        n, sigma, cap = run_shape(system, n, sigma)
    name = str(dtype)[6:]
    kernel = pdip_cuda.solve_socp_cuda
    res = {"device": torch.cuda.get_device_name(device), "system": system,
           "dtype": name, "n": n, "sigma": sigma, "latency": latency,
           "max_iters": cap, "seeds": [], "failures": []}
    for seed in seeds:
        if latency:
            scen = probe_latency.scenario(prob, seed)
            sys_ = prob[0]
            pb = {k: v[None] for k, v in scen[0].items()}
            xb = scen[1][None]
            solve = lambda: altro.tree_map(lambda a: a[None],
                                           probe_latency.solve_one(prob, scen))
        else:
            sys_, pb, xb, ub, cfg = system_problem(
                system, dtype, device, seed=seed, n=n, sigma=sigma,
                max_iters=cap)
            solve = lambda: solve_batch(sys_, pb, cfg, xb, ub)
        torch.cuda.synchronize(device)
        pdip_cuda.launches = 0
        t0 = time.perf_counter()
        st = solve()
        torch.cuda.synchronize(device)
        row = {"seed": seed, "wall_s": time.perf_counter() - t0,
               "pdip_launches": pdip_cuda.launches,
               **solve_stats(sys_, pb, st)}
        if latency:
            missed, jax_mean = batch_failures(row), None
        else:
            missed, jax_mean = guards(system, dtype, n, sigma, seed, row)
        if missed is not None:
            row["guards"] = missed
        if jax_mean is not None:
            row["jax_mean_iters"] = jax_mean
            row["delta_jax"] = row["mean_iters"] - jax_mean
        t0 = time.perf_counter()
        batches = near_contact_batches(sys_, pb, xb, st.X)
        for b in batches:
            b["name"] = f"{system} {name} seed {seed} {b['name']}"
        v = compare(batches, outputs(solve_socp, batches),
                    outputs(kernel, batches))
        row.update(near_contact=v["totals"], batches=v["batches"],
                   near_contact_s=time.perf_counter() - t0)
        what = ("solve_single of probe_latency.scenario" if latency else
                f"{n} scenario(s) at sigma {sigma:g}"
                + ("" if cap is None else f" capped at {cap}"))
        out(f"[hard_lanes] {system} {name} seed {seed}, {what}: "
            f"{row['wall_s']:.3f} s host-bound eager wall, "
            f"{row['pdip_launches']} PDIP launches; converged "
            f"{row['converged']}/{n} (not: "
            f"{sorted(set(range(n)) - set(row['scenarios_converged']))}), "
            f"failed "
            f"{row['failed']}, mean iters {row['mean_iters']:.4f}"
            + (f" (JAX {row['jax_mean_iters']}, delta "
               f"{row['delta_jax']:+.4f})" if "delta_jax" in row else "")
            + f", max {row['max_iters']}; cold re-check max h "
            f"{row['max_h']:.3e}, goal error {row['goal_err']:.3e}; members "
            f"equal: iterations {row['iters_equal']}, X {row['X_equal']}")
        out(f"[hard_lanes]   iters {row['iters']}")
        out(f"[hard_lanes]   {len(batches)} near-contact batches in "
            f"{row['near_contact_s']:.1f} s: "
            + describe_totals(row["near_contact"]))
        log_lanes(v["batches"], out)
        missed = row.get("guards", []) + verdict_failures(row["near_contact"])
        res["failures"] += [f"seed {seed}: {m}" for m in missed]
        for m in missed:
            out(f"[hard_lanes]   FAILS: {m}")
        if capture_dir is not None:
            row["capture"] = capture(batches, v["batches"], capture_dir,
                                     kernel)
            log_capture(row["capture"], out)
        res["seeds"].append(row)
    return res


def mpc_problem(device, S: int = MPC_S, N: int = MPC_N,
                tick_iters: int = MPC_TICK_ITERS):
    """(system, parameters (S, ...), config, x0s (S, nx), U0 (S, N-1, nu))
    of ``bench_mpc.py``'s closed loop (``:93-102``): the f32 quadrotor at
    horizon N, at most ``tick_iters`` ALTRO iterations a tick, S initial
    states X0[0] + N(0, 0.02) from ``default_rng(0)``."""
    from dcol_tpu_torch.systems import quadrotor

    sys_, params, X0, U0, cfg = quadrotor.make_problem(torch.float32, device,
                                                       N=N)
    cfg = dataclasses.replace(cfg, max_iters=tick_iters)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(X0[0].cpu().numpy()[None]
                          + rng.normal(0, 0.02, (S, sys_.nx)),
                          dtype=torch.float32, device=device)
    pb = {k: v[None].expand((S,) + v.shape).contiguous()
          for k, v in params.items()}
    Ub = U0[None].expand((S,) + U0.shape).contiguous()
    return sys_, pb, cfg, x0s, Ub


def judge_mpc(sys_, pb, res, solve) -> Tuple[List[Dict], Dict]:
    """The cold constraint batches at an MPC run's closed-loop states
    ``res.X_applied`` (:func:`constraint_batches`, named "mpc X_applied
    <group>"; the states at which ``h_applied`` is taken), through
    ``solve`` and the plain version, judged by :func:`compare`; beside it
    h = max over obstacles of 1 - alpha from ``solve``'s cold alphas at
    each tick's state, against ``res.h_applied`` (what the ticks' solves
    computed there; reported, not gated).  Returns the batches and the
    verdict."""
    from dcol_tpu_torch.ops.pdip import solve_socp

    batches = constraint_batches(sys_, pb, res.X_applied, "mpc X_applied")
    k_out = outputs(solve, batches)
    v = compare(batches, outputs(solve_socp, batches), k_out)
    S, T = res.X_applied.shape[:2]
    h = torch.stack([(1 - k["alpha"].double()).reshape(S, T, -1).amax(-1)
                     for k in k_out]).amax(0)[:, :-1]
    v.update(h_cold_max=float(h.max()),
             h_applied_max=float(res.h_applied.max()),
             h_max_abs_diff=float((h - res.h_applied.cpu().double())
                                  .abs().max()))
    return batches, v


def run_mpc(device="cuda", out=print, capture_dir=None,
            steps: int = MPC_STEPS) -> Dict:
    """``chip_smoke.py`` phase 8's closed loop (:func:`mpc_problem`) for
    ``steps`` ticks through the kernel, then :func:`judge_mpc` on its
    closed-loop states; with ``capture_dir``, the kernel-only far lanes are
    written there.  ``failures`` lists non-finite states and the rule's
    misses."""
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.solver import mpc

    device = _card(device)
    sys_, pb, cfg, x0s, Ub = mpc_problem(device)
    torch.cuda.synchronize(device)
    pdip_cuda.launches = 0
    t0 = time.perf_counter()
    r = mpc.mpc_run(sys_, pb, cfg, x0s, Ub, steps)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    res = {"device": torch.cuda.get_device_name(device), "S": x0s.shape[0],
           "N": sys_.N, "tick_iters": cfg.max_iters, "steps": steps,
           "wall_s": wall, "pdip_launches": pdip_cuda.launches,
           "mean_iters": float(r.iters.double().mean()),
           "converged_ticks": float(r.converged.double().mean()),
           "finite": bool(torch.isfinite(r.X_applied).all()
                          & torch.isfinite(r.U_applied).all())}
    t0 = time.perf_counter()
    batches, v = judge_mpc(sys_, pb, r, pdip_cuda.solve_socp_cuda)
    res.update(v, judge_s=time.perf_counter() - t0)
    out(f"[hard_lanes] MPC f32 quadrotor S={res['S']} N={res['N']}, "
        f"{steps} ticks x <= {res['tick_iters']} iterations: {wall:.3f} s "
        f"host-bound eager wall, {res['pdip_launches']} PDIP launches, mean "
        f"iterations a tick {res['mean_iters']:.4f}, converged ticks "
        f"{res['converged_ticks']:.4f}, max h_applied "
        f"{res['h_applied_max']:.3e}")
    out(f"[hard_lanes]   {len(res['batches'])} batches at X_applied in "
        f"{res['judge_s']:.1f} s: " + describe_totals(res["totals"])
        + f"; h from the kernel's cold alphas: max {res['h_cold_max']:.3e},"
        f" max |h - h_applied| {res['h_max_abs_diff']:.3e}")
    log_lanes(res["batches"], out)
    res["failures"] = ([] if res["finite"] else
                       ["non-finite states or controls"]) + verdict_failures(
        res["totals"])
    for m in res["failures"]:
        out(f"[hard_lanes]   FAILS: {m}")
    if capture_dir is not None:
        res["capture"] = capture(batches, res["batches"], capture_dir,
                                 pdip_cuda.solve_socp_cuda)
        log_capture(res["capture"], out)
    return res


def parse_seeds(text: str) -> List[int]:
    """Seeds from "1-6", "0", or a comma list of either ("0-2,5")."""
    seeds = []
    for part in text.split(","):
        m = re.fullmatch(r"\s*(\d+)\s*(?:-\s*(\d+)\s*)?", part)
        if not m or int(m.group(2) or m.group(1)) < int(m.group(1)):
            raise argparse.ArgumentTypeError(
                f"seeds {text!r}: give a seed or a range such as 1-6")
        seeds += range(int(m.group(1)), int(m.group(2) or m.group(1)) + 1)
    return seeds


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--capture", metavar="DIR",
                    help="write the kernel-only far lanes of the "
                         "near-contact batches to DIR")
    ap.add_argument("--system", choices=sorted(RUNS),
                    help="solve this system at --seeds (default quadrotor)")
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    help="the solve's dtype (default float32)")
    ap.add_argument("--seeds", type=parse_seeds,
                    help="perturb_scenarios seeds, such as 1-6 (default 0)")
    ap.add_argument("--scenarios", type=int, metavar="N",
                    help="scenarios a seed (default: the system's in RUNS)")
    ap.add_argument("--sigma", type=float, metavar="S",
                    help="perturb_scenarios' x0_sigma (default 0.02, or the "
                         "system's in RUNS without --scenarios; 0: the "
                         "nominal problem)")
    ap.add_argument("--latency", action="store_true",
                    help="each seed's one scenario through solve_single, "
                         "as probe_latency builds it")
    ap.add_argument("--mpc", action="store_true",
                    help="the MPC closed loop and its measured states")
    args = ap.parse_args(argv)
    if args.scenarios is not None and args.scenarios < 1:
        ap.error("--scenarios must be at least 1")
    if args.sigma is not None and args.sigma < 0:
        ap.error("--sigma must be at least 0")
    if args.latency and (args.scenarios, args.sigma) != (None, None):
        ap.error("--latency solves probe_latency's one scenario a seed: "
                 "no --scenarios or --sigma")
    if args.mpc and (args.system, args.dtype, args.seeds, args.scenarios,
                     args.sigma, args.latency) != (None,) * 5 + (False,):
        ap.error("--mpc runs chip_smoke.py phase 8's closed loop: it takes "
                 "only --capture")
    return args


def main(argv=None):
    from dcol_tpu_torch.ops import nvcc_build

    args = parse_args(argv)
    os.makedirs(nvcc_build.BUILD_DIR, exist_ok=True)
    if args.mpc:
        res = run_mpc(capture_dir=args.capture)
        summary = {k: res[k] for k in (
            "steps", "wall_s", "pdip_launches", "mean_iters",
            "converged_ticks", "h_applied_max", "h_cold_max",
            "h_max_abs_diff", "totals", "failures")}
        stem = "hard_lanes_mpc"
    elif (args.system, args.dtype, args.seeds, args.scenarios, args.sigma,
          args.latency) == (None,) * 5 + (False,):
        res = run(capture_dir=args.capture)
        summary = {"traces": {n: {w: t["end"] for w, t in v.items()}
                              for n, v in res["traces"].items()},
                   **{f"{key}_failing": {
                       n: {w: len(x["failing"]) for w, x in v.items()}
                       for n, v in res[key].items()}
                      for key in ("captured", "open")},
                   **res["totals"]}
        stem = "hard_lanes"
    else:
        system, dtype = args.system or "quadrotor", args.dtype or "float32"
        res = run_seeds(system, getattr(torch, dtype), args.seeds or [0],
                        capture_dir=args.capture, n=args.scenarios,
                        sigma=args.sigma, latency=args.latency)
        summary = {"system": system, "dtype": dtype, "n": res["n"],
                   "sigma": res["sigma"], "latency": args.latency,
                   "seeds": [{k: r.get(k) for k in (
                       "seed", "converged", "n", "mean_iters", "delta_jax",
                       "max_iters", "max_h", "goal_err", "iters_equal",
                       "X_equal", "pdip_launches", "wall_s", "near_contact")}
                       for r in res["seeds"]], "failures": res["failures"]}
        stem = f"hard_lanes_{system}_{dtype}_" + (
            "latency" if args.latency else f"{res['n']}x{res['sigma']:g}")
    with open(os.path.join(nvcc_build.BUILD_DIR, stem + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(summary), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(1 if main().get("failures") else 0)
