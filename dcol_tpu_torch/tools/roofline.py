"""Roofline accounting for the port's PDIP kernel on the card.

    python -m dcol_tpu_torch.tools.roofline {analyze,peak,kernel}
    python -m dcol_tpu_torch.tools.roofline solve SYSTEM N [SIGMA]
    python -m dcol_tpu_torch.tools.roofline ab PARENT_CHECKOUT

Port of ``tools/roofline.py``.  Five commands:

1. ``analyze`` (CPU, no card needed): a FLOP tally of the PDIP solve per
   problem, for every obstacle group of the three systems, taken from the
   plain PyTorch solver (:func:`dcol_tpu_torch.ops.pdip.solve_socp`) under a
   dispatch mode that counts each aten op by the rules of the JAX tool's
   ``jaxpr_flops``: an elementwise op counts its output's elements, a matrix
   product 2mnk, a reduction its input's elements, views and copies nothing.
   The count does not depend on what implements the solve.  Also the
   per-member FLOPs of the dynamics Jacobians and the initial rollout.
2. ``peak`` (card): the attainable FMA rate, from 40 chained launches of
   the FMA probe (:mod:`dcol_tpu_torch.ops.fma_peak`) timed with CUDA
   events, in float32 and float64, at the JAX tool's 65,536 lanes and at a
   full-card grid; beside it the nominal rate SMs x lanes per SM x the
   maximum SM clock.
3. ``kernel`` (card): the PDIP kernel on the f32 quadrotor's launches of
   four shapes (``SHAPES``): a, the cold constraint batch at batch 64
   (70,400 pair problems in 7 group launches); b, the main path's warm
   polish batch at batch 128; c, its line-search chunk (4 x b, every other
   problem skipped); d, the main path's cold batch at batch 128.  Per
   launch: the kernel time; the work, sum over problems of init + iters x
   per_iter from the kernel's own iteration counts; the bytes read once and
   written once (``pdip_bytes``, a skipped problem at its own count); the
   bound, the larger of work at the published float32 peak and bytes at
   the published memory rate (``bound_seconds``), the function's own type;
   the share of it; beside it the kernel's ceiling, the same work at the
   peak of the type the kernel iterates in (float64 for these layouts,
   ``pdip_cuda.arith_dtype``); and the share of the measured float32
   peak.
4. ``solve`` (card): one f32 ``solve_batch`` of N scenarios of SYSTEM
   (a ``hard_lanes`` system name) at ``perturb_scenarios(seed=0,
   x0_sigma=SIGMA)`` (default 0.02) with the device time of each PDIP
   launch and its bound, by start and batch size (``main_path_pdip``,
   after one untimed solve): e.g. ``solve piano_mover 64``,
   ``bench_systems.py``'s piano batch.
5. ``ab`` (card): the same launches, saved once, through another
   checkout's kernel (the parent commit's, unpacked) and this one's, in
   turns parent, this, this, parent, one process each; in each process
   also the main path, one batch-128 f32 quadrotor ``solve_batch`` with
   the device time of each of its PDIP launches beside their bound
   (``main_path_pdip``); and, on the launches of the specialisations a
   change may leave as they were (``bits_entries``: the float32 piano, the
   float64 piano and cone), whether the two kernels' outputs agree bit for
   bit.

The TPU tool's count of vector-register instructions has no counterpart
here: it measured the TPU's (8, 128) register layout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# aten ops that move or create data without arithmetic (the JAX tool's
# free set: reshape, broadcast, squeeze, convert, transpose, slice,
# concatenate, copy, stop_gradient), plus constants and host reads
_FREE = {
    "alias", "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "permute", "transpose", "t", "squeeze", "unsqueeze", "slice", "select",
    "stack", "cat", "clone", "copy", "_to_copy", "detach", "lift_fresh",
    "lift_fresh_copy", "unbind", "split", "split_with_sizes", "as_strided",
    "contiguous", "empty", "empty_like", "empty_strided", "new_empty",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "scalar_tensor", "eye", "fill", "zero",
    "is_same_size", "_has_same_storage_numel", "_local_scalar_dense",
    "diagonal", "expand_copy", "view_copy", "tensor", "index_put",
}
_MATMUL = {"mm", "bmm", "mv", "dot", "addmm", "baddbmm", "addmv", "addbmm"}
_MATMUL_ADD = {"addmm", "baddbmm", "addmv", "addbmm"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "all", "any",
           "argmax", "argmin", "linalg_vector_norm", "norm", "logsumexp",
           "var", "std", "nansum"}


def _numel(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel()
    if isinstance(out, (tuple, list)):
        return sum(_numel(o) for o in out)
    return 0


def op_flops(func, args, out) -> float:
    """FLOPs of one aten op call by the rules of the JAX tool."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]  # in-place variant
    if name in _FREE:
        return 0.0
    if name in _MATMUL:
        a = args[1] if name in _MATMUL_ADD else args[0]
        n_out = out.numel()
        flops = 2.0 * n_out * a.shape[-1]
        return flops + (n_out if name in _MATMUL_ADD else 0.0)
    if name in _REDUCE and func._overloadname != "other":
        return float(args[0].numel())
    return float(_numel(out))


class FlopTally(TorchDispatchMode):
    """Counts the FLOPs of every aten op run inside the ``with`` block
    (forward-mode AD included: ``torch.func.jvp``'s tangent ops reach the
    mode as ops of their own)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.flops += op_flops(func, args, out)
        return out


def tally_flops(fn, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)``."""
    with FlopTally() as t:
        fn(*args, **kwargs)
    return t.flops


# ---------------------------------------------------------------------------
# analyze
# ---------------------------------------------------------------------------

def _problems(nv: int, lay, dtype, B: int, seed: int = 0):
    """B strictly feasible random problems of one layout (the values do not
    change the count; they only keep the iterates finite)."""
    from dcol_tpu_torch.ops.cones import gen_e

    rng = np.random.default_rng(seed)
    G = torch.as_tensor(rng.normal(size=(B, lay.nr, nv)), dtype=dtype)
    x0 = torch.as_tensor(rng.normal(size=(B, nv)), dtype=dtype)
    h = (G @ x0[..., None])[..., 0] + gen_e(lay, dtype)
    c = torch.as_tensor(rng.normal(size=(B, nv)), dtype=dtype)
    return c, G, h


def solve_flops(nv: int, lay, dtype, B: int, iters: int,
                warm: bool = False) -> float:
    """Tallied FLOPs of the plain PDIP solve of B problems of layout
    (nv, lay) for exactly ``iters`` iterations (``tol=0`` keeps every
    member iterating); ``warm``: from a warm start (a 3-iteration solve of
    the same problems, not counted)."""
    from dcol_tpu_torch.ops.pdip import solve_socp

    c, G, h = _problems(nv, lay, dtype, B)
    kw = dict(tol=0.0, jitter=1e-6)
    if warm:
        w = solve_socp(c, G, h, lay, max_iters=3, **kw)
        kw["warm"] = (w.x, w.s, w.z)
    return tally_flops(solve_socp, c, G, h, lay, max_iters=iters, **kw)


def pdip_work(nv: int, lay, dtype=torch.float32,
              warm: bool = False) -> Tuple[float, float]:
    """(init_flops, flops_per_iter) of one problem of the plain PDIP solve
    for layout (nv, lay), cold or warm, from one problem run for 1 and for
    2 iterations (the tally is linear in the batch size).  init_flops
    includes the final mu; a skipped problem costs init_flops alone."""
    one, two = (solve_flops(nv, lay, dtype, 1, it, warm) for it in (1, 2))
    return one - (two - one), two - one


# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# FLOP/s outside the tensor cores, and HBM3 bytes/s
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
PEAK_BYTES = 3.35e12


def pdip_bytes(nv: int, lay, dtype, warm: bool = False,
               skip: bool = False, skipped: bool = False) -> int:
    """Bytes one PDIP problem must move: c, G, h (and the warm x, s, z and
    the skip flag) read once; x, s, z, iters (int32) and converged (bool)
    written once.  A ``skipped`` problem (of a warm launch with a skip
    mask) returns its warm-initialised iterate: it reads the flag and the
    warm x, s, z, not c, G or h."""
    e = torch.finfo(dtype).bits // 8
    nr = lay.nr
    read = (0 if skipped else nv + nr * nv + nr) + (
        nv + 2 * nr if warm or skipped else 0)
    return e * (read + nv + 2 * nr) + 4 + 1 + (1 if skip or skipped else 0)


def bound_seconds(flops: float, nbytes: float,
                  dtype=torch.float32) -> Tuple[float, str]:
    """(seconds, what bounds it): the least time the card takes for
    ``flops`` operations at the published peak of ``dtype`` and ``nbytes``
    at the published memory rate, the larger of the two; what bounds it is
    "operations" or "bytes"."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _systems():
    from dcol_tpu_torch.systems import (
        cone_through_wall, piano_mover, quadrotor)
    return (("quadrotor", quadrotor), ("piano", piano_mover),
            ("cone", cone_through_wall))


def group_rows(dtype=torch.float32) -> List[Dict]:
    """One row per obstacle group of the three systems, with its PDIP work
    per problem."""
    from dcol_tpu_torch.ops.cones import ConeLayout

    rows = []
    for name, mod in _systems():
        sys_ = mod.make_problem(dtype, "cpu")[0]
        for pl, idx in sys_.scene.groups:
            lay = ConeLayout(pl.n_ort, pl.s1, pl.s2)
            init, per_iter = pdip_work(pl.nv, lay, dtype)
            rows.append({"system": name, "obstacles": list(idx),
                         "nv": pl.nv, "n_ort": lay.n_ort, "s1": lay.s1,
                         "s2": lay.s2, "init_flops": init,
                         "flops_per_iter": per_iter})
    return rows


def member_flops(dtype=torch.float32) -> Dict[str, float]:
    """Per-member FLOPs of the quadrotor's dynamics Jacobians (one
    forward-mode pass over N-1 knots) and its initial rollout (N-1 RK4
    steps), at the reference horizon N=100."""
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import quadrotor

    sys_, params, X0, U0, _ = quadrotor.make_problem(dtype, "cpu")
    pb = {k: v[None] for k, v in params.items()}
    X, U = params["Xref"][None], U0[None]
    return {
        "N": sys_.N,
        "dynamics_jacobians": tally_flops(
            altro.dynamics_jacobians, sys_, pb, X[:, :-1], U),
        "initial_rollout": tally_flops(
            altro.initial_rollout, sys_, pb, X0[None, 0], U),
    }


def analyze(out=print) -> Dict:
    rows = group_rows()
    out("== PDIP solve: FLOPs per problem (plain-version tally, f32) ==")
    for r in rows:
        out(f"  {r['system']:10s} obs {str(r['obstacles']):10s} "
            f"nv={r['nv']} n_ort={r['n_ort']} s1={r['s1']} s2={r['s2']}: "
            f"init {r['init_flops']:7.0f}, {r['flops_per_iter']:7.0f} per "
            f"iteration")
    from dcol_tpu_torch.systems import quadrotor
    sys_ = quadrotor.make_problem(torch.float32, "cpu")[0]
    B = 64
    quad = [r for r in rows if r["system"] == "quadrotor"]
    per_iter = sum(B * sys_.N * len(r["obstacles"]) * r["flops_per_iter"]
                   for r in quad)
    out(f"\nquadrotor batch-64 constraint batch "
        f"({B * sys_.N * sys_.scene.n_obs:,} pair problems): "
        f"{per_iter / 1e6:.1f} MFLOP per PDIP iteration (all groups)")
    m = member_flops()
    out(f"\nper-member FLOPs (dispatch tally, N={m['N']}):")
    out(f"  dynamics_jacobians (jvp of RK4, {m['N'] - 1} knots): "
        f"{m['dynamics_jacobians'] / 1e6:.2f} MFLOP")
    out(f"  initial_rollout ({m['N'] - 1} RK4 steps):         "
        f"{m['initial_rollout'] / 1e6:.2f} MFLOP")
    out(f"  batch 64: jac {64 * m['dynamics_jacobians'] / 1e6:.0f} "
        f"MFLOP/call, rollout {64 * m['initial_rollout'] / 1e6:.0f} "
        f"MFLOP/call")
    return {"groups": rows, "batch64_flops_per_iter": per_iter,
            "member": m}


# ---------------------------------------------------------------------------
# peak (card)
# ---------------------------------------------------------------------------

# FP32 and FP64 lanes per SM of the H100 (compute capability 9.0; NVIDIA's
# CUDA programming guide, arithmetic-instruction throughput table)
_LANES = {(9, 0): (128, 64)}
# the JAX tool's probe: 200 passes of 64 FMAs per lane, 40 chained launches
PEAK_INNER = 200
PEAK_CALLS = 40
# the JAX tool's PDIP batch: the f32 quadrotor at 64 scenarios; timed launches
KERNEL_BATCH = 64
KERNEL_REPS = 20


def _require_cuda(device):
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("this roofline command measures the card: it "
                           "needs CUDA")
    return device


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    return float(out[0])


def nominal(device="cuda") -> Dict:
    """Nominal FMA rates: SMs x lanes per SM x the maximum SM clock."""
    device = _require_cuda(device)
    props = torch.cuda.get_device_properties(device)
    cc = (props.major, props.minor)
    if cc not in _LANES:
        raise RuntimeError(f"no lane count known for compute capability {cc}")
    f32_lanes, f64_lanes = _LANES[cc]
    mhz = max_sm_clock_mhz()
    sms = props.multi_processor_count
    return {"sms": sms, "max_sm_clock_mhz": mhz, "fp32_lanes_per_sm":
            f32_lanes, "fp64_lanes_per_sm": f64_lanes,
            "f32_fma_per_s": sms * f32_lanes * mhz * 1e6,
            "f64_fma_per_s": sms * f64_lanes * mhz * 1e6}


def grid_sizes(device="cuda") -> Dict[str, int]:
    """The JAX tool's 65,536 lanes (64 tiles of 8 x 128) and a full-card
    grid: 4 waves of every SM's full thread count."""
    props = torch.cuda.get_device_properties(_require_cuda(device))
    per_sm = getattr(props, "max_threads_per_multi_processor", 2048)
    return {"jax": 64 * 8 * 128,
            "full_card": 4 * props.multi_processor_count * per_sm}


def peak_input(dtype, lanes: int, device) -> torch.Tensor:
    """The probe's operands as the JAX tool fills them: (10, lanes) of
    0.9999."""
    return torch.full((10, lanes), 0.9999, dtype=dtype, device=device)


def peak(dtype=torch.float32, lanes: int = 65536, device="cuda") -> Dict:
    """FMA rate of PEAK_CALLS chained probe launches over ``lanes`` lanes,
    timed with CUDA events after one warm-up launch."""
    from dcol_tpu_torch.ops.fma_peak import FMAS_PER_PASS, fma_chains_cuda

    device = _require_cuda(device)
    x = peak_input(dtype, lanes, device)
    out = fma_chains_cuda(x, PEAK_INNER)
    torch.cuda.synchronize(device)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(PEAK_CALLS):
        out = fma_chains_cuda(x, PEAK_INNER)
    t1.record()
    torch.cuda.synchronize(device)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("FMA probe returned non-finite values")
    ms = t0.elapsed_time(t1) / PEAK_CALLS
    fmas = lanes * PEAK_INNER * FMAS_PER_PASS
    return {"dtype": str(dtype).replace("torch.", ""), "lanes": lanes,
            "inner": PEAK_INNER, "calls": PEAK_CALLS, "ms_per_call": ms,
            "fma_per_s": fmas / (ms * 1e-3),
            "tflops": 2.0 * fmas / (ms * 1e-3) / 1e12}


def peak_table(device="cuda", out=print) -> Dict:
    nom = nominal(device)
    grids = grid_sizes(device)
    rows = []
    out(f"nominal: {nom['sms']} SMs x {nom['fp32_lanes_per_sm']} FP32 / "
        f"{nom['fp64_lanes_per_sm']} FP64 lanes x "
        f"{nom['max_sm_clock_mhz']:.0f} MHz max SM clock")
    for dtype in (torch.float32, torch.float64):
        key = "f32" if dtype == torch.float32 else "f64"
        nom_rate = nom[f"{key}_fma_per_s"]
        for gname, lanes in grids.items():
            r = peak(dtype, lanes, device=device)
            r.update(grid=gname, nominal_fma_per_s=nom_rate,
                     of_nominal=r["fma_per_s"] / nom_rate)
            rows.append(r)
            out(f"FMA peak {key} {gname:9s} {lanes:>9,} lanes: "
                f"{r['ms_per_call']:.4f} ms/call, "
                f"{r['fma_per_s'] / 1e9:,.1f} G FMA/s = "
                f"{r['tflops']:.2f} TFLOP/s ({100 * r['of_nominal']:.1f}% "
                f"of nominal {nom_rate / 1e9:,.1f} G FMA/s = "
                f"{2 * nom_rate / 1e12:.2f} TFLOP/s)")
    return {"nominal": nom, "rows": rows}


# ---------------------------------------------------------------------------
# kernel (card)
# ---------------------------------------------------------------------------

# The PDIP launches the roofline times, on the f32 quadrotor's constraint
# batches at the initial rollouts of perturb_scenarios(seed=0,
# x0_sigma=0.02), one launch per obstacle group:
#   a: cold, at KERNEL_BATCH scenarios (the JAX tool's batch);
#   b: the main path's warm polish shape: MAIN_BATCH scenarios, G and h
#      scaled by 1 + 1e-3, warm-started from the plain cold solution;
#   c: its line-search chunk: b's problems at LS_CHUNK candidate steps (G
#      and h scaled by 1 + j 1e-3, j = 1..LS_CHUNK), every other one skipped;
#   d: the main path's cold launches: b's problems, cold and unscaled.
SHAPES = {"a": "cold, batch 64", "b": "warm, batch 128",
          "c": "warm + every other lane skipped, 4 x batch 128",
          "d": "cold, batch 128"}
MAIN_BATCH = 128
LS_CHUNK = 4


def kernel_shapes(device) -> Tuple[List[Dict], Dict]:
    """The launches of shapes a-d (see SHAPES) as dicts of their operands,
    and the solver options."""
    from dcol_tpu_torch.ops.cones import ConeLayout
    from dcol_tpu_torch.ops.pdip import solve_socp
    from dcol_tpu_torch.parallel.batch import perturb_scenarios
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import quadrotor

    f32 = torch.float32
    sys_, params, X0, U0, _ = quadrotor.make_problem(f32, device)
    scene, opts = sys_.scene, sys_.scene.opts
    kw = dict(tol=opts.tol, max_iters=opts.max_iters, jitter=opts.jitter)
    entries = []
    for shape, n in (("a", KERNEL_BATCH), ("b", MAIN_BATCH)):
        pb, xb, ub = perturb_scenarios(params, X0, U0, n=n, seed=0,
                                       x0_sigma=0.02)
        X = altro.initial_rollout(sys_, pb, xb[:, 0], ub)
        rs, ps = sys_.robot_pose(X)
        grouped = scene.assemble_groups(rs, ps, pb["obs_r"][:, None],
                                        pb["obs_p"][:, None])
        for (pl, idx), (c, G, h) in zip(scene.groups, grouped):
            lay = ConeLayout(pl.n_ort, pl.s1, pl.s2)
            B = c.shape[0] * c.shape[1] * c.shape[2]
            c, G, h = (a.reshape((B,) + a.shape[3:]).contiguous()
                       for a in (c, G, h))
            e = dict(obstacles=list(idx), nv=pl.nv, lay=lay, warm=None,
                     skip=None)
            if shape == "a":
                entries.append(dict(e, shape="a", c=c, G=G, h=h))
                continue
            entries.append(dict(e, shape="d", c=c, G=G, h=h))
            base = solve_socp(c, G, h, lay, **kw)
            warm = (base.x, base.s, base.z)
            entries.append(dict(e, shape="b", c=c, G=G * (1 + 1e-3),
                                h=h * (1 + 1e-3), warm=warm))
            rep = lambda a: a.repeat((LS_CHUNK,) + (1,) * (a.dim() - 1))
            scale = (1 + 1e-3 * torch.arange(1, LS_CHUNK + 1, dtype=f32,
                                             device=device)
                     ).repeat_interleave(B)
            entries.append(dict(
                e, shape="c", c=rep(c), G=rep(G) * scale[:, None, None],
                h=rep(h) * scale[:, None], warm=tuple(rep(a) for a in warm),
                skip=torch.arange(LS_CHUNK * B, device=device) % 2 == 0))
    return entries, kw


# the systems and dtypes whose kernel specialisations ``ab`` holds bit for
# bit against the other checkout's: the float32 piano (no SOC block,
# iterated in float32) and the float64 piano and cone
BITS_SYSTEMS = (("piano_mover", torch.float32), ("piano_mover", torch.float64),
                ("coneThroughWall", torch.float64))
BITS_SCENARIOS = 32


def bits_entries(device) -> List[Dict]:
    """The launches ``ab`` compares bit for bit: for each of BITS_SYSTEMS,
    the near-contact batches (``hard_lanes.near_contact_batches``) of
    BITS_SCENARIOS scenarios at their initial rollout, each cold, warm (G, h
    x 1.001 from the plain version's cold optimum) and warm with every other
    problem skipped."""
    from dcol_tpu_torch.ops.pdip import solve_socp
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.tools import hard_lanes

    out = []
    for system, dtype in BITS_SYSTEMS:
        sys_, pb, xb, ub, _ = hard_lanes.system_problem(
            system, dtype, device, seed=0, n=BITS_SCENARIOS)
        X = altro.initial_rollout(sys_, pb, xb[:, 0], ub)
        for b in hard_lanes.near_contact_batches(sys_, pb, xb, X):
            c, G, h, kw = b["c"], b["G"], b["h"], b["kw"]
            ref = solve_socp(c, G, h, b["lay"], **kw)
            warm = (ref.x, ref.s, ref.z)
            G2, h2 = G * (1 + 1e-3), h * (1 + 1e-3)
            skip = torch.arange(c.shape[0], device=device) % 2 == 0
            e = dict(nv=b["nv"], lay=b["lay"], kw=kw)
            name = f"{system} {str(dtype)[6:]} {b['name']}"
            out += [dict(e, name=name + " cold", c=c, G=G, h=h, warm=None,
                         skip=None),
                    dict(e, name=name + " warm", c=c, G=G2, h=h2, warm=warm,
                         skip=None),
                    dict(e, name=name + " warm+skip", c=c, G=G2, h=h2,
                         warm=warm, skip=skip)]
    return out


def time_launch(fn, reps: int = KERNEL_REPS) -> Tuple[float, object]:
    """Mean device ms of fn() over ``reps`` launches (CUDA events, after
    one warm-up launch) and the warm-up's result."""
    out = fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, out


_WORK: Dict = {}


def start_of(warm, skip) -> str:
    """How a launch starts its problems: "cold", "warm" or "warm+skip"."""
    return "cold" if warm is None else "warm" if skip is None else "warm+skip"


def account(nv: int, lay, start: str, B: int, ms: float, iters_sum: float,
            n_skip: int = 0, peak_flops: Optional[float] = None,
            arith=None) -> Dict:
    """Work, bytes, bound and shares of one launch of B float32 problems of
    layout (nv, lay), ``n_skip`` of them skipped, that took ``ms`` and ran
    ``iters_sum`` iterations over its problems.

    The bound (``bound_ms``) is the function's: its operations at the
    float32 peak and its bytes in float32, the type of its operands, its
    outputs, its plain version and the TPU kernel it replaces.  Beside it,
    ``arith_bound_ms`` is the kernel's own ceiling: the same operations at
    the peak of ``arith``, the type the kernel iterates in (default
    ``pdip_cuda.arith_dtype``: float64 for a layout with an SOC block), and
    the same bytes."""
    from dcol_tpu_torch.ops import pdip_cuda

    f32 = torch.float32
    warm, skip = start != "cold", start == "warm+skip"
    key = (nv, lay, warm)
    if key not in _WORK:
        _WORK[key] = pdip_work(nv, lay, f32, warm)
    init, per_iter = _WORK[key]
    flops = B * init + per_iter * iters_sum
    nbytes = ((B - n_skip) * pdip_bytes(nv, lay, f32, warm, skip)
              + n_skip * pdip_bytes(nv, lay, f32, skipped=True))
    if arith is None:
        arith = pdip_cuda.arith_dtype(f32, lay)
    bound, by = bound_seconds(flops, nbytes, f32)
    ceiling, _ = bound_seconds(flops, nbytes, arith)
    row = {"nv": nv, "layout": [lay.n_ort, lay.s1, lay.s2], "start": start,
           "B": B, "ms": ms, "mean_iters": iters_sum / B, "skipped": n_skip,
           "flops": flops, "bytes": nbytes, "bound_ms": 1e3 * bound,
           "bound_by": by, "of_bound": 1e3 * bound / ms,
           "arith": str(arith)[6:], "arith_bound_ms": 1e3 * ceiling,
           "of_arith_bound": 1e3 * ceiling / ms}
    if peak_flops:
        row["of_peak"] = flops / (ms * 1e-3 * peak_flops)
    return row


def account_entry(e: Dict, ms: float, iters_sum: float,
                  peak_flops: Optional[float] = None, arith=None) -> Dict:
    """``account`` of one launch of a ``kernel_shapes`` entry (float32)."""
    skip = e["skip"]
    return dict(account(e["nv"], e["lay"], start_of(e["warm"], skip),
                        e["c"].shape[0], ms, iters_sum,
                        0 if skip is None else int(skip.sum()), peak_flops,
                        arith=arith),
                shape=e["shape"], obstacles=e["obstacles"])


def shape_totals(rows: List[Dict]) -> Dict:
    """Sums over a shape's launches: ms, FLOPs, bytes, bound ms and the
    kernel's ceiling ms (sums of the per-launch ones)."""
    tot = {k: sum(r[k] for r in rows)
           for k in ("ms", "flops", "bytes", "bound_ms", "arith_bound_ms")}
    tot["of_bound"] = tot["bound_ms"] / tot["ms"]
    tot["of_arith_bound"] = tot["arith_bound_ms"] / tot["ms"]
    by = {r["bound_by"] for r in rows}
    tot["bound_by"] = by.pop() if len(by) == 1 else "mixed"
    return tot


def kernel(peak_flops: Optional[float] = None, device="cuda",
           out=print) -> Dict:
    """Each launch of shapes a-d through the PDIP kernel: time, work from
    the kernel's own iteration counts, bytes, bound and share of it, and
    share of ``peak_flops`` (the measured float32 FMA peak at the full-card
    grid if not given)."""
    from dcol_tpu_torch.ops import pdip_cuda

    device = _require_cuda(device)
    if peak_flops is None:
        lanes = grid_sizes(device)["full_card"]
        peak_flops = peak(torch.float32, lanes, device=device)["tflops"] * 1e12
    entries, kw = kernel_shapes(device)
    res = {"peak_flops": peak_flops, "rows": [], "totals": {}}
    for shape, what in SHAPES.items():
        rows = []
        for e in (e for e in entries if e["shape"] == shape):
            ms, sol = time_launch(lambda: pdip_cuda.solve_socp_cuda(
                e["c"], e["G"], e["h"], e["lay"], warm=e["warm"],
                skip=e["skip"], **kw))
            row = account_entry(e, ms, float(sol.iters.double().sum()),
                                peak_flops)
            rows.append(row)
            out(f"{shape} group {str(e['obstacles']):8s} nv={e['nv']} "
                f"{e['lay']} B={row['B']}: {ms:.4f} ms, mean iters "
                f"{row['mean_iters']:.3f}, {row['flops'] / 1e6:.1f} MFLOP, "
                f"{row['bytes'] / 1e6:.2f} MB, bound "
                f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
                f"{100 * row['of_bound']:.2f}% of bound, kernel's ceiling "
                f"({row['arith']}) {row['arith_bound_ms'] * 1e3:.2f} us, "
                f"{100 * row['of_peak']:.2f}% of the measured peak")
        tot = shape_totals(rows)
        tot["of_peak"] = tot["flops"] / (tot["ms"] * 1e-3 * peak_flops)
        res["rows"] += rows
        res["totals"][shape] = tot
        out(f"{shape} ({what}), {len(rows)} launches: {tot['ms']:.4f} ms, "
            f"{tot['flops'] / 1e6:.1f} MFLOP, {tot['bytes'] / 1e6:.2f} MB, "
            f"bound {tot['bound_ms'] * 1e3:.2f} us ({tot['bound_by']}), "
            f"{100 * tot['of_bound']:.2f}% of bound, kernel's ceiling "
            f"{tot['arith_bound_ms'] * 1e3:.2f} us, "
            f"{100 * tot['of_peak']:.2f}% of the measured f32 peak "
            f"{peak_flops / 1e12:.2f} TFLOP/s")
    return res


# A spin kernel queued before each timed PDIP launch keeps the device busy
# while the host records the first event and launches the kernel, so the
# events bracket the kernel and not the host's launch latency (on the main
# path the device is otherwise idle most of the time).
SPIN_CYCLES = 200_000  # ~0.1 ms at the H100's 1,980 MHz


def main_path_pdip(device="cuda", system: str = "quadrotor",
                   n: int = MAIN_BATCH, sigma: float = 0.02) -> Dict:
    """One f32 ``solve_batch`` of ``n`` scenarios of ``system`` at
    ``perturb_scenarios(seed=0, x0_sigma=sigma)`` (by default the main
    path, the batch-128 quadrotor, as ``chip_smoke.py`` drives it) with the
    device time of every PDIP kernel launch taken.  By (start, B):
    launches, kernel ms, problems, skipped problems, PDIP iterations, and
    the bound from those counts; their sums; and the solve's converged
    count, mean ALTRO iterations and wall.  It solves with the
    ``dcol_tpu_torch`` found first on ``sys.path``, so ``ab`` can run it on
    another checkout's package."""
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.parallel.batch import perturb_scenarios, solve_batch
    from dcol_tpu_torch.systems import base
    from dcol_tpu_torch.tools import hard_lanes

    device = _require_cuda(device)
    calls, kernels = [], []

    class Timed:
        """A kernel library whose launches are bracketed by events."""

        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name)

        def dcol_pdip_solve(self, *args):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(SPIN_CYCLES)
            t0.record()
            rc = self.lib.dcol_pdip_solve(*args)
            t1.record()
            kernels.append((t0, t1))
            return rc

    def counted_solve(c, G, h, lay, **kw):
        # the counts the bound needs, left on the device until the end
        sol = solve(c, G, h, lay, **kw)
        skip = kw.get("skip")
        calls.append((start_of(kw.get("warm"), skip), c.shape[0],
                      c.shape[-1], lay, kernels[-1], sol.iters.sum(),
                      0 if skip is None else skip.sum()))
        return sol

    lib, solve = pdip_cuda._lib, base.solve_socp_cuda
    pdip_cuda._lib = lambda *a: Timed(lib(*a))
    base.solve_socp_cuda = counted_solve
    try:
        sys_, params, X0, U0, cfg = hard_lanes.system_module(
            system).make_problem(torch.float32, device)
        pb, xb, ub = perturb_scenarios(params, X0, U0, n=n, seed=0,
                                       x0_sigma=sigma)
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        st = solve_batch(sys_, pb, cfg, xb, ub)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    finally:
        pdip_cuda._lib, base.solve_socp_cuda = lib, solve
    by = {}
    keys = ("launches", "ms", "bound_ms", "arith_bound_ms", "skipped",
            "problems", "iters")
    for start, B, nv, lay, (t0, t1), iters, n_skip in calls:
        row = account(nv, lay, start, B, t0.elapsed_time(t1), float(iters),
                      int(n_skip))
        sums = by.setdefault((start, B), dict.fromkeys(keys, 0))
        for k, v in zip(keys, (1, row["ms"], row["bound_ms"],
                               row["arith_bound_ms"], row["skipped"], B,
                               float(iters))):
            sums[k] += v
    rows = [dict(v, start=k[0], B=k[1]) for k, v in sorted(by.items())]
    return {"wall_s": wall, "converged": int(st.converged.sum()),
            "mean_iters": float(st.iter.double().mean()), "by_shape": rows,
            **{k: sum(r[k] for r in rows) for k in keys}}


def solve_table(system: str, n: int, sigma: float = 0.02, device="cuda",
                out=print) -> Dict:
    """:func:`main_path_pdip` of ``n`` scenarios of ``system`` at
    ``sigma``, printed by (start, B): launches, summed and per-launch
    device ms, bound and the kernel's ceiling.  The same solve runs once
    before, untimed: its first launch of each specialisation builds and
    loads the kernel, which the events would count."""
    main_path_pdip(device, system=system, n=n, sigma=sigma)
    res = main_path_pdip(device, system=system, n=n, sigma=sigma)
    out(f"{system} f32, {n} scenarios at sigma {sigma:g}, seed 0: "
        f"{res['launches']} PDIP launches, {res['ms']:.3f} ms "
        f"({res['ms'] / res['launches']:.4f} ms a launch), bound "
        f"{res['bound_ms']:.4f} ms ({100 * res['bound_ms'] / res['ms']:.2f}%"
        f"), kernel's ceiling {res['arith_bound_ms']:.4f} ms; converged "
        f"{res['converged']}/{n}, mean iterations {res['mean_iters']:.4f}, "
        f"wall {res['wall_s']:.2f} s")
    for r in res["by_shape"]:
        out(f"  {r['start']:9s} B={r['B']:>7,}: {r['launches']} launches, "
            f"{r['ms']:.3f} ms ({r['ms'] / r['launches']:.4f} a launch), "
            f"bound {r['bound_ms']:.4f} ms, kernel's ceiling "
            f"{r['arith_bound_ms']:.4f} ms; skipped {r['skipped']:,} of "
            f"{r['problems']:,}")
    return res


# Run in a subprocess from the root of a checkout (this one or another
# commit's): times that checkout's PDIP kernel on the saved launches and on
# the main path, and hashes its outputs on the saved ``bits`` launches, with
# this file's helpers, loaded by path so that the package they drive is the
# checkout's.
_TIMER = r"""
import hashlib, importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
import torch
spec = importlib.util.spec_from_file_location("roofline_timer", sys.argv[3])
timer = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timer)
from dcol_tpu_torch.ops import nvcc_build, pdip_cuda
from dcol_tpu_torch.ops.cones import ConeLayout
data = torch.load(sys.argv[2])
dev = torch.device("cuda")
ents, bits = ([dict(e, lay=ConeLayout(*e["lay"])) for e in data[k]]
              for k in ("entries", "bits"))
nvcc_build.run_parallel([
    (lambda e=e: pdip_cuda.build(e["c"].dtype, e["nv"], e["lay"]))
    for e in ents + bits])
to_dev = lambda e: {k: (None if e[k] is None else
                        tuple(v.to(dev) for v in e[k]) if k == "warm" else
                        e[k].to(dev)) for k in ("c", "G", "h", "warm", "skip")}
digests = []
for e in bits:
    a = to_dev(e)
    sol = pdip_cuda.solve_socp_cuda(a["c"], a["G"], a["h"], e["lay"],
                                    warm=a["warm"], skip=a["skip"], **e["kw"])
    h = hashlib.sha256()
    for t in sol:
        h.update(t.cpu().numpy().tobytes())
    digests.append(h.hexdigest())
rows = []
for e in ents:
    a = to_dev(e)
    ms, sol = timer.time_launch(lambda: pdip_cuda.solve_socp_cuda(
        a["c"], a["G"], a["h"], e["lay"], warm=a["warm"], skip=a["skip"],
        **data["kw"]))
    rows.append({"shape": e["shape"], "ms": ms,
                 "iters_sum": float(sol.iters.double().sum()),
                 "converged": int(sol.converged.sum()),
                 "arith": str(pdip_cuda.arith_dtype(torch.float32,
                                                    e["lay"]))[6:]})
print(json.dumps({"launches": rows, "bits": digests,
                  "main": timer.main_path_pdip(dev)}))
"""


def ab(parent: str, device="cuda", out=print) -> Dict:
    """The PDIP kernel of another checkout (``parent``, e.g. an unpacked
    ``git archive`` of the parent commit) against this one's, in the order
    parent, this, this, parent, one process each: on the same saved
    launches of shapes a-d, then on the main path (``main_path_pdip``);
    and whether each checkout gives the same outputs bit for bit (x, s, z,
    iterations and flags; SHA-256) on the saved :func:`bits_entries`."""
    from dcol_tpu_torch.ops import nvcc_build

    device = _require_cuda(device)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parent = os.path.abspath(parent)
    entries, kw = kernel_shapes(device)
    os.makedirs(nvcc_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(nvcc_build.BUILD_DIR, "ab_inputs.pt")
    cpu = lambda v: (None if v is None else tuple(a.cpu() for a in v)
                     if isinstance(v, tuple) else v.cpu())
    flat = lambda e, **more: dict(
        more, nv=e["nv"], lay=(e["lay"].n_ort, e["lay"].s1, e["lay"].s2),
        **{k: cpu(e[k]) for k in ("c", "G", "h", "warm", "skip")})
    bits = bits_entries(device)
    torch.save({"kw": kw,
                "entries": [flat(e, shape=e["shape"]) for e in entries],
                "bits": [flat(e, kw=e["kw"]) for e in bits]}, path)
    runs = []
    for name, tree in (("parent", parent), ("this", here), ("this", here),
                       ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, "-c", _TIMER, tree, path,
             os.path.abspath(__file__)], cwd=tree, capture_output=True,
            text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"timer in {tree} failed:\n{proc.stderr}")
        runs.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
    res = {"runs": runs, "totals": [], "main": [], "bits": []}
    both = lambda vals, fmt: " / ".join(format(v, fmt) for v in vals)
    for i, e in enumerate(bits):
        got = {name: {run["bits"][i] for n, run in runs if n == name}
               for name in ("parent", "this")}
        res["bits"].append({"name": e["name"], "repeatable": all(
            len(d) == 1 for d in got.values()),
            "equal": got["parent"] == got["this"]})
    differ = [r["name"] for r in res["bits"] if not r["equal"]]
    out(f"bitwise: {len(bits) - len(differ)} of {len(bits)} launches of "
        f"the float32 piano and the float64 piano and cone give the "
        f"parent's outputs bit for bit; each tree's two runs agree: "
        f"{all(r['repeatable'] for r in res['bits'])}"
        + (f"; differ: {', '.join(differ)}" if differ else ""))
    for name in ("parent", "this"):
        mine = [r for n, r in runs if n == name]
        for shape, what in SHAPES.items():
            ents = [e for e in entries if e["shape"] == shape]
            per_run = [[r for r in run["launches"] if r["shape"] == shape]
                       for run in mine]
            accounted = [[account_entry(e, r["ms"], r["iters_sum"],
                                        arith=getattr(torch, r["arith"]))
                          for e, r in zip(ents, rs)] for rs in per_run]
            tots = [shape_totals(rows) for rows in accounted]
            conv = sum(r["converged"] for r in per_run[0])
            row = {"tree": name, "shape": shape,
                   "ms": [x["ms"] for x in tots],
                   "bound_ms": tots[0]["bound_ms"],
                   "bound_by": tots[0]["bound_by"],
                   "of_bound": [x["of_bound"] for x in tots],
                   "arith_bound_ms": tots[0]["arith_bound_ms"],
                   "launch_ms": [[r["ms"] for r in rows]
                                 for rows in accounted],
                   "converged": conv,
                   "problems": sum(e["c"].shape[0] for e in ents)}
            res["totals"].append(row)
            out(f"{name:6s} {shape} ({what}): {both(row['ms'], '.4f')} ms in "
                f"{len(ents)} launches (two runs), bound "
                f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
                f"{both((100 * x for x in row['of_bound']), '.2f')}% of "
                f"bound, kernel's ceiling {row['arith_bound_ms'] * 1e3:.2f} "
                f"us; converged {conv}/{row['problems']}")
        main = [run["main"] for run in mine]
        res["main"].append({"tree": name, "runs": main})
        m0 = main[0]
        out(f"{name:6s} main path, batch-128 solve_batch, {m0['launches']} "
            f"PDIP launches (two runs): "
            f"{both((m['ms'] for m in main), '.3f')} ms, bound "
            f"{m0['bound_ms']:.3f} ms, kernel's ceiling "
            f"{m0['arith_bound_ms']:.3f} ms; skipped problems "
            f"{m0['skipped']:,} "
            f"of {m0['problems']:,}, the others "
            f"{m0['iters'] / (m0['problems'] - m0['skipped']):.3f} PDIP "
            f"iterations on average; converged {m0['converged']}/{MAIN_BATCH}, "
            f"mean iterations {m0['mean_iters']:.4f}, wall "
            f"{both((m['wall_s'] for m in main), '.2f')} s")
        for sh in m0["by_shape"]:
            key = (sh["start"], sh["B"])
            got = [x for m in main for x in m["by_shape"]
                   if (x["start"], x["B"]) == key]
            out(f"{name:6s}   {sh['start']:9s} B={sh['B']:>7,}: "
                f"{sh['launches']} launches, "
                f"{both((x['ms'] for x in got), '.3f')} ms, bound "
                f"{sh['bound_ms']:.3f} ms, kernel's ceiling "
                f"{sh['arith_bound_ms']:.3f} ms; skipped {sh['skipped']:,} of "
                f"{sh['problems']:,}, the others "
                f"{sh['iters'] / (sh['problems'] - sh['skipped']):.3f} "
                f"iterations on average")
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else "analyze"
    if cmd == "analyze":
        return analyze()
    if cmd == "peak":
        return peak_table()
    if cmd == "kernel":
        return kernel()
    if cmd == "solve" and len(argv) > 2:
        return solve_table(argv[1], int(argv[2]),
                           *(float(a) for a in argv[3:4]))
    if cmd == "ab" and len(argv) > 1:
        from dcol_tpu_torch.ops import nvcc_build

        res = ab(argv[1])
        path = os.path.join(nvcc_build.BUILD_DIR, "roofline_ab.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        print(f"per-launch times: {path}")
        return res
    raise SystemExit("usage: python -m dcol_tpu_torch.tools.roofline "
                     "[analyze|peak|kernel|solve SYSTEM N [SIGMA]|"
                     "ab PARENT_CHECKOUT]")


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"({time.perf_counter() - t0:.1f} s)")
