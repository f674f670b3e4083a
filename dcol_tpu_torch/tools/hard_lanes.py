"""Hard lanes of the PDIP kernel on the card: near-contact problems, where
float32 rounding decides whether a lane converges.

    python -m dcol_tpu_torch.tools.hard_lanes

Two measurements, each of the kernel against its plain PyTorch version on
the same card:

1. the near-contact fixture ``tests/torch_fixtures/pdip_near_contact_f32.npz``
   (a cold batch of the f32 quadrotor's obstacle group (1, 7) at the solved
   trajectory of ``chip_smoke.py``'s latency scenario, B = 200, as the card
   computed it): its far lane's trace by ``max_iters`` (:func:`trace`), the
   kernel alone (B = 1) and in its place in the batch;
2. near-contact batches of the main path: one batch-128 f32 quadrotor
   ``solve_batch``, then the 7 obstacle groups' cold constraint batches at
   the solved trajectories and at the midpoints of the initial and solved
   ones (14 launches, 281,600 problems); per batch, the converged counts
   and the lanes that end far from tol (mu >= 10 tol) in one version only.

To measure another checkout's kernel (an unpacked ``git archive`` of the
parent, say), run this file from that checkout's root with it first on the
path, ``PYTHONPATH=. python <this checkout>/dcol_tpu_torch/tools/hard_lanes.py``:
the fixture is this checkout's, the batches come from that checkout's own
solve.  Needs a CUDA device and raises without one; the record goes to
``dcol_tpu_torch/build/hard_lanes.json``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "torch_fixtures",
    "pdip_near_contact_f32.npz")
BORDER = 10  # a lane that ends at mu >= BORDER x tol stopped far from tol


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


def main_path_state(device):
    """One batch-128 f32 quadrotor solve of the main path (``chip_smoke.py``
    phase 4's scenarios): (system, scenario parameters, initial and solved
    trajectories)."""
    from dcol_tpu_torch.parallel.batch import perturb_scenarios, solve_batch
    from dcol_tpu_torch.systems import quadrotor

    sys_, params, X0, U0, cfg = quadrotor.make_problem(torch.float32, device)
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=128, seed=0,
                                   x0_sigma=0.02)
    return sys_, pb, xb, solve_batch(sys_, pb, cfg, xb, ub).X


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
    """``solve`` on each batch: converged flags, mu and alpha, on the CPU."""
    rows = []
    for b in batches:
        o = solve(b["c"], b["G"], b["h"], b["lay"], **b["kw"])
        rows.append({"converged": o.converged.cpu(),
                     "mu": mu_of(o, b["lay"]).cpu(),
                     "alpha": o.x[:, 3].cpu()})
    return rows


def compare(batches, plain, kernel) -> Dict:
    """Kernel against plain per batch: converged counts and the lanes that
    end far from tol in one version only."""
    rows, tot = [], {"problems": 0, "conv_kernel": 0, "conv_plain": 0,
                     "kernel_only_far": 0, "plain_only_far": 0}
    for b, p, k in zip(batches, plain, kernel):
        bd = BORDER * b["kw"]["tol"]
        kf = ((k["mu"] >= bd) & (p["mu"] < bd)).nonzero()[:, 0].tolist()
        pf = ((p["mu"] >= bd) & (k["mu"] < bd)).nonzero()[:, 0].tolist()
        r = {"batch": b["name"], "B": b["c"].shape[0],
             "conv_kernel": int(k["converged"].sum()),
             "conv_plain": int(p["converged"].sum()),
             "kernel_only_far": kf, "plain_only_far": pf,
             "max_abs_err_alpha": float((k["alpha"] - p["alpha"]).abs()
                                        .max())}
        rows.append(r)
        for key in ("conv_kernel", "conv_plain"):
            tot[key] += r[key]
        tot["problems"] += r["B"]
        tot["kernel_only_far"] += len(kf)
        tot["plain_only_far"] += len(pf)
    return {"batches": rows, "totals": tot}


def run(device="cuda", out=print) -> Dict:
    """Both measurements of this process's kernel against the plain
    version."""
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.pdip import solve_socp

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("hard_lanes measures the card's kernel: it needs "
                           "CUDA")
    fx = load_fixture(device)
    batches = near_contact_batches(*main_path_state(device))
    res = {"device": torch.cuda.get_device_name(device),
           "traces": {"plain": fixture_traces(solve_socp, fx),
                      "kernel": fixture_traces(pdip_cuda.solve_socp_cuda,
                                               fx)},
           **compare(batches, outputs(solve_socp, batches),
                     outputs(pdip_cuda.solve_socp_cuda, batches))}
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
        f"{tot['plain_only_far']}")
    for r in res["batches"]:
        if r["kernel_only_far"] or r["plain_only_far"]:
            out(f"[hard_lanes]   {r['batch']} B={r['B']:,}: kernel only "
                f"{r['kernel_only_far']}, plain only {r['plain_only_far']}")
    return res


def main():
    from dcol_tpu_torch.ops import nvcc_build

    res = run()
    os.makedirs(nvcc_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(nvcc_build.BUILD_DIR, "hard_lanes.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"traces": {n: {w: t["end"] for w, t in v.items()}
                                 for n, v in res["traces"].items()},
                      **res["totals"]}), flush=True)
    return res


if __name__ == "__main__":
    main()
