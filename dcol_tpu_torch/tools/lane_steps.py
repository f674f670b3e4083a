"""One captured lane, step by step: where the PDIP kernel's iterates part
from the plain version's.

    python -m dcol_tpu_torch.tools.lane_steps LANE.npz [--steps K0-K1]

``LANE.npz`` is a lane written by ``hard_lanes --capture``
(``tests/torch_fixtures/pdip_hard_lane_*.npz``).  On the lane alone (B =
1), with its batch's settings:

1. each version's iterate after k = 1 .. max_iters steps (:func:`iterates`,
   a solve with ``max_iters = k``: the solver is deterministic, so each
   repeats the one before and takes one more step) and its mu;
2. for each k in ``--steps`` (default: the three steps before plain's last),
   one step of each version from each version's iterate k (:func:`step`, a
   warm start with no margin, which leaves an interior iterate as it is):
   the mu it reaches, beside the f64 plain step from the same iterate.  A
   version whose step from the other's iterate is as good as the other's
   own step does not differ in that step's arithmetic.

Measures the kernel of the checkout it runs from: to measure another
checkout's, run this file from that checkout's root with it first on the
path, as ``hard_lanes`` says (it needs only that checkout's
``hard_lanes.load_lane`` and ``mu_of``).  Needs a CUDA device and raises
without one.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np
import torch

from dcol_tpu_torch.tools import hard_lanes


def iterates(solve, lane: Dict) -> Dict[str, np.ndarray]:
    """x, s, z (each (max_iters, n)), the steps taken and mu (float64) of
    ``solve`` on the lane alone after max_iters = 1 .. its max_iters."""
    i, lay, kw = lane["lane"], lane["lay"], lane["kw"]
    one = [lane[k][i:i + 1].contiguous() for k in "cGh"]
    rows = [solve(*one, lay, **dict(kw, max_iters=k))
            for k in range(1, kw["max_iters"] + 1)]
    out = {n: np.stack([getattr(o, n)[0].cpu().numpy() for o in rows])
           for n in "xsz"}
    out["steps"] = np.array([int(o.iters[0]) for o in rows])
    out["mu"] = np.array([float(hard_lanes.mu_of(o, lay)[0]) for o in rows])
    return out


def step(solve, lane: Dict, its: Dict[str, np.ndarray], k: int,
         dtype=None) -> float:
    """mu after one step of ``solve`` from iterate k of :func:`iterates`
    (in ``dtype`` if given: the problem and iterate cast to it)."""
    i, lay, kw = lane["lane"], lane["lay"], lane["kw"]
    dev = lane["c"].device
    cast = (lambda a: a) if dtype is None else (lambda a: a.to(dtype))
    one = [cast(lane[n][i:i + 1]) for n in "cGh"]
    warm = tuple(cast(torch.as_tensor(its[n][k - 1], device=dev)[None])
                 for n in "xsz")
    o = solve(*one, lay, **dict(kw, max_iters=1), warm=warm, warm_margin=0.0)
    return float(hard_lanes.mu_of(o, lay)[0])


def run(path: str, steps=None, device="cuda", out=print) -> Dict:
    """Both measurements of this checkout's kernel on the lane in ``path``;
    ``steps``: the k of the one-step table (default the three before
    plain's last step)."""
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.pdip import solve_socp

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("lane_steps measures the card's kernel: it needs "
                           "CUDA")
    lane = hard_lanes.load_lane(path, device)
    solvers = {"kernel": pdip_cuda.solve_socp_cuda, "plain": solve_socp}
    its = {n: iterates(s, lane) for n, s in solvers.items()}
    for n, t in its.items():
        out(f"[lane_steps] {lane['name']} {n}: steps {t['steps'].tolist()}; "
            "mu " + " ".join(f"{m:.3e}" for m in t["mu"]))
    if steps is None:
        last = int(its["plain"]["steps"][-1])
        steps = range(max(1, last - 3), last)
    table: List[Dict] = []
    for k in steps:
        for src in solvers:
            row = {"k": k, "from": src,
                   "mu": float(its[src]["mu"][k - 1]),
                   **{n: step(s, lane, its[src], k)
                      for n, s in solvers.items()},
                   "plain_f64": step(solve_socp, lane, its[src], k,
                                     torch.float64)}
            table.append(row)
            out(f"[lane_steps] one step from the {src}'s iterate {k} (mu "
                f"{row['mu']:.3e}): kernel {row['kernel']:.3e}, plain "
                f"{row['plain']:.3e}, plain f64 {row['plain_f64']:.3e}")
    return {"device": torch.cuda.get_device_name(device), "lane": path,
            "mu": {n: t["mu"].tolist() for n, t in its.items()},
            "steps": {n: t["steps"].tolist() for n, t in its.items()},
            "one_step": table}


def parse_steps(text: str) -> range:
    """k0-k1 (or one k) to the range of steps it names."""
    lo, _, hi = text.partition("-")
    if not (lo.isdigit() and (hi or lo).isdigit()) or int(hi or lo) < int(lo):
        raise argparse.ArgumentTypeError(f"steps {text!r}: give k or k0-k1")
    return range(int(lo), int(hi or lo) + 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lane", help="a lane written by hard_lanes --capture")
    ap.add_argument("--steps", type=parse_steps,
                    help="the k of the one-step table, such as 13-15")
    args = ap.parse_args(argv)
    res = run(args.lane, args.steps)
    print(json.dumps(res["one_step"]), flush=True)
    return res


if __name__ == "__main__":
    main()
