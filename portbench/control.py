"""The readings that the limits of ``correct`` are set from, in one
process: for each seed, one run of a cell at the cell's own size (a short
window), its compared numbers, and beside them the control's: the plain
reference put in the program's place and computed in the precision below
the configuration's (float32 with TF32 matrix products, where the
configuration states float32 with TF32 off), judged against the cell's
limits as the program is.  With ``--fault`` the runs have that fault of
:mod:`portbench.harness.faults` planted in the timed path.

    python portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 8 [--fault frozen]

Prints one JSON line per seed (the program's ``correct``, the control's
``control_correct`` and the numbers) and a summary: for each number the
largest reading of the runs (the lower reading, or with a fault the
fault's) and the smallest control reading (the upper one).  Needs a CUDA
device; the benchmark's own runs do not run it."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_judged(out):
    """(correct, [(name, value, limit)]) of the control: its readings of
    the compared numbers it has, against the same limits."""
    from portbench.harness import check

    nums = out["numbers"]
    limits = {k: c["limit"] for k, c in out["checks"].items()
              if k + "_control" in nums}
    return check.judge({k: nums[k + "_control"] for k in limits}, limits)


def readings(reg, cell: str, seeds, seconds: float, device, out=print,
             fault: str = None):
    """{number: {"program": [...], "control": [...]}} over ``seeds``, and
    the [(seed, correct, control_correct)] of the runs."""
    from portbench.harness import faults, runner

    got, verdicts = {}, []
    for seed in seeds:
        with (faults.planted(fault) if fault else contextlib.nullcontext()):
            res = runner.run_cell(reg, cell, seed, seconds, False, device,
                                  time.perf_counter(), control=True)
        nums = res["numbers"]
        c_ok, _ = control_judged(res)
        verdicts.append((seed, res["correct"], c_ok))
        out(json.dumps({"seed": seed, "fault": fault,
                        "correct": res["correct"], "control_correct": c_ok,
                        "numbers": nums}))
        for k, v in nums.items():
            if k.endswith("_control"):
                got.setdefault(k[:-8], {}).setdefault("control", []).append(v)
            elif isinstance(v, float):
                got.setdefault(k, {}).setdefault("program", []).append(v)
    return got, verdicts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from portbench.harness import runner
    from portbench.harness.registry import Registry

    why = runner.require_cuda(1)
    if why:
        print(f"portbench: {why}", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    got, verdicts = readings(Registry(), args.workload, seeds, args.seconds,
                             "cuda", fault=args.fault)
    summary = {k: {"lower": max(v.get("program", [float("nan")])),
                   "upper": min(v["control"]) if "control" in v else None}
               for k, v in got.items()}
    print(json.dumps({"workload": args.workload, "seeds": seeds,
                      "fault": args.fault, "verdicts": verdicts,
                      "summary": summary, "readings": got}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
