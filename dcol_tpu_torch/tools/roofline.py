"""Roofline accounting for the port's PDIP kernel on the card.

    python -m dcol_tpu_torch.tools.roofline {analyze,peak,kernel}

Port of ``tools/roofline.py``.  Three commands:

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
3. ``kernel`` (card): the cold grouped PDIP constraint batch of the f32
   quadrotor at batch 64 (70,400 pair problems, 7 groups), each group's
   kernel time, its work sum over lanes of (init + iters * per_iter) from
   the kernel's own iteration counts, and utilization = work / (time x the
   measured float32 peak).

The TPU tool's count of vector-register instructions has no counterpart
here: it measured the TPU's (8, 128) register layout.
"""

from __future__ import annotations

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


def solve_flops(nv: int, lay, dtype, B: int, iters: int) -> float:
    """Tallied FLOPs of the plain PDIP solve of B problems of layout
    (nv, lay) for exactly ``iters`` iterations (``tol=0`` keeps every
    member iterating)."""
    from dcol_tpu_torch.ops.pdip import solve_socp

    c, G, h = _problems(nv, lay, dtype, B)
    return tally_flops(solve_socp, c, G, h, lay, tol=0.0, max_iters=iters,
                       jitter=1e-6)


def pdip_work(nv: int, lay, dtype=torch.float32) -> Tuple[float, float]:
    """(init_flops, flops_per_iter) of one problem of the plain PDIP solve
    for layout (nv, lay), from one problem run for 1 and for 2 iterations
    (the tally is linear in the batch size)."""
    one, two = (solve_flops(nv, lay, dtype, 1, it) for it in (1, 2))
    return one - (two - one), two - one


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
KERNEL_REPS = 10


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

def kernel_cold(peak_flops: Optional[float] = None, device="cuda",
                out=print) -> Dict:
    """Per obstacle group of the f32 quadrotor at KERNEL_BATCH scenarios:
    the cold kernel time (CUDA events, mean of KERNEL_REPS launches after
    one warm-up), the work from the kernel's iteration counts, and the
    utilization against ``peak_flops`` (measured at the full-card grid if
    not given)."""
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.cones import ConeLayout
    from dcol_tpu_torch.parallel.batch import perturb_scenarios
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import quadrotor

    device = _require_cuda(device)
    if peak_flops is None:
        lanes = grid_sizes(device)["full_card"]
        peak_flops = peak(torch.float32, lanes, device=device)["tflops"] * 1e12
    f32 = torch.float32
    sys_, params, X0, U0, _ = quadrotor.make_problem(f32, device)
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=KERNEL_BATCH, seed=0,
                                   x0_sigma=0.02)
    X = altro.initial_rollout(sys_, pb, xb[:, 0], ub)
    scene, opts = sys_.scene, sys_.scene.opts
    rs, ps = sys_.robot_pose(X)
    grouped = scene.assemble_groups(rs, ps, pb["obs_r"][:, None],
                                    pb["obs_p"][:, None])
    kw = dict(tol=opts.tol, max_iters=opts.max_iters, jitter=opts.jitter)
    rows, tot_ms, tot_work = [], 0.0, 0.0
    for (pl, idx), (c, G, h) in zip(scene.groups, grouped):
        lay = ConeLayout(pl.n_ort, pl.s1, pl.s2)
        B = c.shape[0] * c.shape[1] * c.shape[2]
        c, G, h = (a.reshape((B,) + a.shape[3:]).contiguous()
                   for a in (c, G, h))
        sol = pdip_cuda.solve_socp_cuda(c, G, h, lay, **kw)
        torch.cuda.synchronize(device)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(KERNEL_REPS):
            pdip_cuda.solve_socp_cuda(c, G, h, lay, **kw)
        t1.record()
        torch.cuda.synchronize(device)
        ms = t0.elapsed_time(t1) / KERNEL_REPS
        init, per_iter = pdip_work(pl.nv, lay, f32)
        iters = sol.iters.double()
        work = float(B * init + per_iter * iters.sum())
        util = work / (ms * 1e-3 * peak_flops)
        rows.append({"obstacles": list(idx), "nv": pl.nv, "n_ort": lay.n_ort,
                     "s1": lay.s1, "s2": lay.s2, "B": B, "ms": ms,
                     "mean_iters": float(iters.mean()), "work_flops": work,
                     "gflops": work / (ms * 1e-3) / 1e9,
                     "utilization": util})
        tot_ms += ms
        tot_work += work
        out(f"group {str(list(idx)):8s} nv={pl.nv} {lay} B={B}: "
            f"{ms:.4f} ms, mean iters {float(iters.mean()):.3f}, work "
            f"{work / 1e6:.1f} MFLOP, {work / (ms * 1e-3) / 1e9:.1f} "
            f"GFLOP/s, utilization {util:.5f}")
    util = tot_work / (tot_ms * 1e-3 * peak_flops)
    out(f"cold constraint batch ({sum(r['B'] for r in rows):,} pair "
        f"problems): {tot_ms:.4f} ms in {len(rows)} launches, {tot_work / 1e6:.1f} "
        f"MFLOP, utilization {util:.5f} of the measured f32 peak "
        f"{peak_flops / 1e12:.2f} TFLOP/s")
    return {"groups": rows, "ms": tot_ms, "work_flops": tot_work,
            "utilization": util, "peak_flops": peak_flops}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0] if argv else "analyze"
    if cmd == "analyze":
        return analyze()
    if cmd == "peak":
        return peak_table()
    if cmd == "kernel":
        return kernel_cold()
    raise SystemExit("usage: python -m dcol_tpu_torch.tools.roofline "
                     "[analyze|peak|kernel]")


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"({time.perf_counter() - t0:.1f} s)")
