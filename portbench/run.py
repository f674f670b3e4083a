"""Run one cell of the port's benchmark once.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress and, as its last lines on standard error, each number
compared with the plain reference beside its limit; its last line on
standard output is the result, one JSON object.  Needs a CUDA device and
exits with an error, printing no result, without one; it never falls back
to the CPU."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host drives the card from one thread,
# and idle worker threads of the CPU pools would only compete with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    from portbench.harness import imports, runner
    from portbench.harness.registry import Registry

    torch.set_num_threads(1)

    reg = Registry()
    cell = reg.cell(args.workload)
    why = runner.require_cuda(cell["chips"])
    if why:
        print(f"portbench: {why}", file=sys.stderr)
        return 2
    out = runner.run_cell(reg, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T_START)
    bad = imports.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
