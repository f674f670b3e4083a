"""Replicated scenarios: where identical problems in one batch part.

    python -m dcol_tpu_torch.tools.replicas [--device cuda] [--replicas 64]

``benchmarks/bench_systems.py`` runs the cone through the wall as its
nominal problem replicated 64 times, and every replica should come out
bit for bit the same.  On the card they part.  This tool locates where,
on the f32 cone's nominal problem replicated N times:

1. the PDIP solver on each of the cone's near-contact batches (at the
   nominal initial rollout) with every problem replicated N times, cold,
   warm and warm+skip: the problems whose replicas differ in any output;
2. the envelope gradients at the replicated cone's first polish: the
   members whose d_p differ, and the Lagrangian's G x formed by each of
   ``FORMS`` on the same tangents;
3. the total cost after one ALTRO iteration (its states still equal),
   summed by each of ``SUMS``;
4. each combination of a G x form and a cost sum (and the port's own
   with the plain PDIP version on the same device): the nominal f32
   piano's ALTRO iterations, and the replicated cone's solve (iterations,
   converged, the members whose X parts from the first, the largest
   difference).

The port's own forms are ``systems/base.py::lagrangian_gx`` and
``solver/altro.py::_sum_knots``; the others are put in their place for
the run and restored.  Runs on the CPU too (the plain version), where
nothing parts.  The last line is the result as JSON; the record goes to
``dcol_tpu_torch/build/replicas_<device>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Tuple

import torch

F32 = torch.float32
CONE, PIANO = "coneThroughWall", "piano_mover"
CONE_CAP = 80  # the ALTRO cap of hard_lanes' cone runs


def _elementwise(G, x):
    return torch.sum(G * x[..., None, :], dim=-1)


def _one_reduction(a):
    return torch.sum(a, dim=(-2, -1))


def forms() -> Dict:
    """G x forms: the port's batched matmul, and the elementwise
    contraction the JAX package uses."""
    from dcol_tpu_torch.systems import base

    return {"matmul": base.lagrangian_gx, "elementwise": _elementwise}


def sums() -> Dict:
    """Cost sums over (knots, components): one reduction, and the port's
    one dim at a time."""
    from dcol_tpu_torch.solver import altro

    return {"one reduction": _one_reduction,
            "one dim at a time": altro._sum_knots}


def parted(t: torch.Tensor) -> Tuple[int, float]:
    """(members that differ from the first anywhere, the largest
    difference); NaN equals NaN."""
    same = (t == t[:1]) | (t.isnan() & t[:1].isnan())
    bad = ~same.reshape(t.shape[0], -1).all(1)
    return int(bad.sum()), float((t.double() - t[:1].double()).abs()
                                 .nan_to_num().max())


def _cone(device, n, cap=None):
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.tools import hard_lanes

    sys_, pb, xb, ub, cfg = hard_lanes.system_problem(
        CONE, F32, device, seed=0, n=n, sigma=0.0, max_iters=cap)
    return sys_, pb, xb, ub, cfg, altro.make_initial_state(sys_, pb, cfg,
                                                           xb, ub)


def _solver(device):
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.pdip import solve_socp

    return pdip_cuda.solve_socp_cuda if device.type == "cuda" else solve_socp


def pdip_replicas(device, n: int) -> Dict:
    """1: per near-contact batch and start, the problems whose n replicas
    differ in any output of the PDIP solver of ``device``."""
    from dcol_tpu_torch.ops.pdip import solve_socp
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.tools import hard_lanes

    sys_, pb, xb, ub, _, _ = _cone(device, 1)
    X = altro.initial_rollout(sys_, pb, xb[:, 0], ub)
    solve, out = _solver(device), {}
    for b in hard_lanes.near_contact_batches(sys_, pb, xb, X):
        B = b["c"].shape[0]
        c, G, h = (a.repeat_interleave(n, 0) for a in (b["c"], b["G"],
                                                        b["h"]))
        base = solve_socp(c, G, h, b["lay"], **b["kw"])
        skip = (torch.arange(n * B, device=device) // n) % 2 == 0
        for start, kw, GG, hh in (
                ("cold", {}, G, h),
                ("warm", {"warm": (base.x, base.s, base.z)},
                 G * (1 + 1e-3), h * (1 + 1e-3)),
                ("warm+skip", {"warm": (base.x, base.s, base.z),
                               "skip": skip}, G * (1 + 1e-3),
                 h * (1 + 1e-3))):
            o = solve(c, GG, hh, b["lay"], **b["kw"], **kw)
            bad = torch.zeros(B, dtype=torch.bool, device=device)
            for t in o:
                t = t.reshape(B, n, -1)
                bad |= ~(t == t[:, :1]).all(-1).all(-1)
            out[f"{b['name']} {start}"] = {"B": B, "parted": int(bad.sum())}
    return out


def first_polish(device, n: int) -> Dict:
    """2: the members whose envelope gradients part at the replicated
    cone's first polish, and G x by each form on the same tangents."""
    from dcol_tpu_torch.systems.base import jvp

    sys_, pb, _, _, _, st = _cone(device, n)
    scene = sys_.scene
    _, gx, _ = sys_.constraints_x_vg_traj(pb, st.X, warm=st.warm)
    rs, ps = sys_.robot_pose(st.X)
    sols, _ = scene._solve_groups_traj(rs, ps, pb["obs_r"], pb["obs_p"],
                                       st.warm,
                                       margin=scene.opts.polish_margin)
    S, T = rs.shape[:2]
    x = sols[0].x.reshape(S, T, -1, sols[0].x.shape[-1])
    basis = torch.eye(6, dtype=F32, device=device)[:, None, None, :]
    shape6 = (6,) + rs.shape
    _, (_, dG, _) = jvp(
        lambda r_, p_: scene.assemble_groups(
            r_, p_, pb["obs_r"][:, None], pb["obs_p"][:, None])[0],
        (rs.expand(shape6).contiguous(), ps.expand(shape6).contiguous()),
        (basis[..., :3].expand(shape6).contiguous(),
         basis[..., 3:].expand(shape6).contiguous()))
    out = {"gx": parted(gx), "x": parted(x)}
    for name, f in forms().items():
        out[f"G x, {name}"] = parted(f(dG, x).movedim(0, 1))
    return out


def cost_after_one(device, n: int) -> Dict:
    """3: after one ALTRO iteration, the members whose states part, and
    whose total cost parts under each sum."""
    from dcol_tpu_torch.solver import altro

    sys_, pb, _, _, cfg, st = _cone(device, n)
    st = altro.altro_iteration(sys_, pb, cfg, st)
    out = {k: parted(getattr(st, k)) for k in ("X", "U", "mux", "hx")}
    keep = altro._sum_knots
    try:
        for name, f in sums().items():
            altro._sum_knots = f
            out[f"J, {name}"] = parted(altro.total_cost(
                sys_, pb, st.X, st.U, st.hx, st.hu, st.mu, st.mux, st.lambd,
                st.rho))
    finally:
        altro._sum_knots = keep
    return out


def variants(device, n: int, out=print) -> list:
    """4: each (G x form, cost sum), and the port's own with the plain
    PDIP version: the nominal f32 piano's iterations, the replicated
    cone's solve."""
    from dcol_tpu_torch.parallel.batch import solve_batch
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import base
    from dcol_tpu_torch.tools import hard_lanes

    keep = (base.lagrangian_gx, altro._sum_knots, base.solve_socp_cuda)
    runs = [(f, s, False) for f in forms() for s in sums()]
    if device.type == "cuda":
        runs.append(("matmul", "one dim at a time", True))
    rows = []
    try:
        for f, s, plain in runs:
            base.lagrangian_gx, altro._sum_knots = forms()[f], sums()[s]
            if plain:
                base.solve_socp_cuda = base.solve_socp
            sys_, pb, xb, ub, cfg = hard_lanes.system_problem(
                PIANO, F32, device, seed=0, n=1, sigma=0.0)
            piano = int(solve_batch(sys_, pb, cfg, xb, ub).iter[0])
            sys_, pb, xb, ub, cfg, _ = _cone(device, n, CONE_CAP)
            t0 = time.perf_counter()
            st = solve_batch(sys_, pb, cfg, xb, ub)
            nX, dX = parted(st.X)
            row = {"G x": f, "sums": s, "pdip": "plain" if plain else
                   ("kernel" if device.type == "cuda" else "plain"),
                   "piano_f32_iters": piano,
                   "cone_iters": sorted(set(st.iter.tolist())),
                   "cone_converged": int(st.converged.sum()),
                   "cone_X_parted": nX, "cone_max_dX": dX,
                   "cone_wall_s": time.perf_counter() - t0}
            rows.append(row)
            out(f"[replicas] G x {f}, sums {s}, PDIP {row['pdip']}: f32 "
                f"piano {piano} iterations; cone x{n} iterations "
                f"{row['cone_iters']}, converged {row['cone_converged']}, "
                f"X parted in {nX} members (max {dX:.3e})")
    finally:
        base.lagrangian_gx, altro._sum_knots, base.solve_socp_cuda = keep
    return rows


def run(device="cuda", n: int = 64, out=print) -> Dict:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("replicas on the card needs CUDA")
    res = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"), "replicas": n,
           "pdip": pdip_replicas(device, n)}
    out(f"[replicas] PDIP on the cone's near-contact batches x{n}, problems "
        "whose replicas differ: " + ", ".join(
            f"{k} {v['parted']}/{v['B']}" for k, v in res["pdip"].items()))
    res["first_polish"] = first_polish(device, n)
    out("[replicas] first polish, members parted (max difference): "
        + ", ".join(f"{k} {v[0]} ({v[1]:.3e})"
                    for k, v in res["first_polish"].items()))
    res["after_one"] = cost_after_one(device, n)
    out("[replicas] after one iteration, members parted: "
        + ", ".join(f"{k} {v[0]} ({v[1]:.3e})"
                    for k, v in res["after_one"].items()))
    res["variants"] = variants(device, n, out)
    return res


def main(argv=None):
    from dcol_tpu_torch.ops import nvcc_build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=64)
    args = ap.parse_args(argv)
    res = run(args.device, args.replicas)
    os.makedirs(nvcc_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(nvcc_build.BUILD_DIR,
                        f"replicas_{torch.device(args.device).type}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
