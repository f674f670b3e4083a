"""Hard lanes of the PDIP kernel on the card: near-contact problems, where
float32 rounding decides whether a lane converges.

    python -m dcol_tpu_torch.tools.hard_lanes [--capture DIR]

Three measurements, each of the kernel against its plain PyTorch version on
the same card, judged lane by lane by :func:`judge_lanes`:

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
   kernel on each, alone and in its warp, judged by the rule.

To measure another checkout's kernel (an unpacked ``git archive`` of the
parent, say), run this file from that checkout's root with it first on the
path, ``PYTHONPATH=. python <this checkout>/dcol_tpu_torch/tools/hard_lanes.py``:
the fixtures are this checkout's, the batches come from that checkout's own
solve.  Needs a CUDA device and raises without one; the record goes to
``dcol_tpu_torch/build/hard_lanes.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "torch_fixtures")
FIXTURE = os.path.join(FIXTURES, "pdip_near_contact_f32.npz")
CAPTURED = "pdip_hard_lane_*.npz"
BORDER = 10  # a lane that ends at mu >= BORDER x tol stopped far from tol
# the rule's alpha floor, relative to 1 + |alpha of the f64 solve|
ALPHA_ATOL = 1e-4
# a lane far from tol in the plain version only: both versions' alpha
# within FAR_ALPHA_TOL x (1 + |alpha of the f64 solve|)
FAR_ALPHA_TOL = 2e-3
F64_KW = dict(tol=1e-9, max_iters=40)  # the reference solve of a lane
WARP = 32


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


def describe_lane(row) -> str:
    return (f"lane {row['lane']}: mu kernel {row['mu_kernel']:.3e}, plain "
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


def main_path_state(device, solved: Optional[torch.Tensor] = None):
    """The main path's batch-128 f32 quadrotor (``chip_smoke.py`` phase 4's
    scenarios): (system, scenario parameters, initial and solved
    trajectories).  ``solved``: the solved trajectories of that solve, if
    the caller already ran it; else this solves the batch."""
    from dcol_tpu_torch.parallel.batch import perturb_scenarios, solve_batch
    from dcol_tpu_torch.systems import quadrotor

    sys_, params, X0, U0, cfg = quadrotor.make_problem(torch.float32, device)
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=128, seed=0,
                                   x0_sigma=0.02)
    if solved is None:
        solved = solve_batch(sys_, pb, cfg, xb, ub).X
    return sys_, pb, xb, solved


def near_contact_batches(sys_, pb, xb, X) -> List[Dict]:
    """The obstacle groups' cold constraint batches at the solved
    trajectories ``X`` and at the midpoints of ``xb`` and ``X``, each flat:
    {"name", "nv", "lay", "c", "G", "h", "kw"}."""
    from dcol_tpu_torch.ops.cones import ConeLayout

    opts = sys_.scene.opts
    kw = dict(tol=opts.tol, max_iters=opts.max_iters, jitter=opts.jitter)
    out = []
    for tag, Xt in (("solved", X), ("midpoint", 0.5 * (X + xb))):
        rs, ps = sys_.robot_pose(Xt)
        grouped = sys_.scene.assemble_groups(rs, ps, pb["obs_r"][:, None],
                                             pb["obs_p"][:, None])
        for (lay, idx), (c, G, h) in zip(sys_.scene.groups, grouped):
            out.append({"name": f"{tag} {idx}", "nv": lay.nv,
                        "lay": ConeLayout(lay.n_ort, lay.s1, lay.s2), "kw": kw,
                        **{k: a.reshape((-1,) + a.shape[3:]).contiguous()
                           for k, a in (("c", c), ("G", G), ("h", h))}})
    return out


def outputs(solve, batches) -> List[Dict]:
    """``solve`` on each batch: :func:`lanes_of` its solution."""
    return [lanes_of(solve(b["c"], b["G"], b["h"], b["lay"], **b["kw"]),
                     b["lay"]) for b in batches]


def compare(batches, plain, kernel) -> Dict:
    """Kernel against plain per batch: converged counts, the lanes that end
    far from tol in one version only, and the rule's verdict
    (:func:`judge_lanes`)."""
    rows, tot = [], {"problems": 0, "conv_kernel": 0, "conv_plain": 0,
                     "disputed": 0, "failing": 0, "kernel_only_far": 0,
                     "plain_only_far": 0}
    for b, p, k in zip(batches, plain, kernel):
        v = judge_lanes(k, p, b["lay"], (b["c"], b["G"], b["h"]),
                        b["kw"]["tol"])
        r = {"batch": b["name"], "B": b["c"].shape[0],
             "conv_kernel": int(k["converged"].sum()),
             "conv_plain": int(p["converged"].sum()),
             "max_abs_err_alpha": float((k["alpha"] - p["alpha"]).abs()
                                        .max()), **v}
        rows.append(r)
        for key in ("conv_kernel", "conv_plain", "disputed"):
            tot[key] += r[key]
        tot["problems"] += r["B"]
        for key in ("failing", "kernel_only_far", "plain_only_far"):
            tot[key] += len(r[key])
    return {"batches": rows, "totals": tot}


def capture(batches, verdicts, directory, solve) -> List[Dict]:
    """Write each lane that ends far from tol in the kernel only to
    ``directory``/pdip_hard_lane_<batch>_<lane>.npz: the problems of its
    warp (32 / team lanes, as the kernel launched them together), its index
    there, its batch's name, layout and settings, whether the kernel
    (``solve``) still stops far on it alone, and each version's mu and
    alpha with the f64 solve's alpha."""
    from dcol_tpu_torch.ops.pdip_cuda import team_lanes

    os.makedirs(directory, exist_ok=True)
    saved = []
    for b, v in zip(batches, verdicts):
        lay, kw, B = b["lay"], b["kw"], b["c"].shape[0]
        per_warp = WARP // team_lanes(lay.nr, b["c"].dtype)
        for row in v["lanes"]:
            lane = row["lane"]
            if lane not in v["kernel_only_far"]:
                continue
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


def captured_lanes() -> List[str]:
    """The captured lanes' files, sorted."""
    return sorted(glob.glob(os.path.join(FIXTURES, CAPTURED)))


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
    and in its warp, each judged by the rule on that lane:
    {"alone": verdict, "in its warp": verdict}."""
    from dcol_tpu_torch.ops.pdip import solve_socp

    c, G, h, lay, kw, i = (lane[k] for k in ("c", "G", "h", "lay", "kw",
                                              "lane"))
    out = {}
    for where, prob, j in (
            ("alone", tuple(a[i:i + 1].contiguous() for a in (c, G, h)), 0),
            ("in its warp", (c, G, h), i)):
        sel = slice(j, j + 1)
        got, ref = (lanes_of(s(*prob, lay, **kw), lay)
                    for s in (solve, solve_socp))
        out[where] = judge_lanes({n: t[sel] for n, t in got.items()},
                                 {n: t[sel] for n, t in ref.items()}, lay,
                                 tuple(a[sel] for a in prob), kw["tol"])
        out[where].update(mu=float(got["mu"][j]),
                          alpha=float(got["alpha"][j]))
    return out


def run(device="cuda", out=print, capture_dir=None) -> Dict:
    """The three measurements of this process's kernel against the plain
    version; with ``capture_dir``, the kernel-only far lanes of the
    near-contact batches are written there (:func:`capture`)."""
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.pdip import solve_socp

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("hard_lanes measures the card's kernel: it needs "
                           "CUDA")
    fx = load_fixture(device)
    kernel = pdip_cuda.solve_socp_cuda
    batches = near_contact_batches(*main_path_state(device))
    res = {"device": torch.cuda.get_device_name(device),
           "traces": {"plain": fixture_traces(solve_socp, fx),
                      "kernel": fixture_traces(kernel, fx)},
           **compare(batches, outputs(solve_socp, batches),
                     outputs(kernel, batches)),
           "captured": {os.path.basename(p): judge_captured(
               kernel, load_lane(p, device)) for p in captured_lanes()}}
    for name, traces in res["traces"].items():
        for where, t in traces.items():
            out(f"[hard_lanes] fixture lane {fx['lane']}, {name} {where}: "
                f"{t['end']}; (max_iters, steps, mu) "
                + " ".join(f"{k}:{it}:{mu:.2e}" for k, it, mu in t["rows"]))
    tot = res["totals"]
    out(f"[hard_lanes] kernel on {len(batches)} near-contact batches "
        f"({tot['problems']:,} problems): converged {tot['conv_kernel']:,} "
        f"(plain {tot['conv_plain']:,}); far from tol in the kernel only "
        f"{tot['kernel_only_far']}, in the plain version only "
        f"{tot['plain_only_far']}; the rule: {tot['disputed']} disputed "
        f"lanes, {tot['failing']} failing")
    for r in res["batches"]:
        for row in r["lanes"]:
            out(f"[hard_lanes]   {r['batch']} B={r['B']:,} "
                + describe_lane(row))
    for name, v in res["captured"].items():
        for where, w in v.items():
            out(f"[hard_lanes] captured {name}, kernel {where}: mu "
                f"{w['mu']:.3e}, alpha {w['alpha']:.7f}, failing "
                f"{len(w['failing'])}" + "".join(
                    f"; {describe_lane(row)}" for row in w["lanes"]))
    if capture_dir is not None:
        res["capture"] = capture(batches, res["batches"], capture_dir,
                                 kernel)
        for s in res["capture"]:
            out(f"[hard_lanes] captured {s['batch']} lane {s['lane']} to "
                f"{s['path']}: kernel alone mu {s['mu_kernel_alone']:.3e}; "
                + describe_lane(s))
    return res


def main(argv=None):
    from dcol_tpu_torch.ops import nvcc_build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--capture", metavar="DIR",
                    help="write the kernel-only far lanes of the "
                         "near-contact batches to DIR")
    args = ap.parse_args(argv)
    res = run(capture_dir=args.capture)
    os.makedirs(nvcc_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(nvcc_build.BUILD_DIR, "hard_lanes.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"traces": {n: {w: t["end"] for w, t in v.items()}
                                 for n, v in res["traces"].items()},
                      "captured_failing": {
                          n: {w: len(x["failing"]) for w, x in v.items()}
                          for n, v in res["captured"].items()},
                      **res["totals"]}), flush=True)
    return res


if __name__ == "__main__":
    main()
