"""Command-line entry point of the port:

    python -m dcol_tpu_torch.main --system {quadrotor,piano_mover,coneThroughWall}
        [--batch N] [--f32 | --f64] --device {cuda,cpu}

Without ``--batch`` it solves the system once and prints the iteration
table; with ``--batch N`` it solves N perturbed scenarios and prints a
summary.  The default dtype is float32 on cuda and float64 on cpu.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="DCOL trajectory optimisation (PyTorch / CUDA port).")
    parser.add_argument("--system", required=True,
                        choices=["piano_mover", "quadrotor",
                                 "coneThroughWall"])
    parser.add_argument("--batch", type=int, default=0,
                        help="solve a batch of perturbed scenarios instead "
                             "of one")
    prec = parser.add_mutually_exclusive_group()
    prec.add_argument("--f32", action="store_true", help="float32")
    prec.add_argument("--f64", action="store_true", help="float64")
    parser.add_argument("--device", required=True, choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from dcol_tpu_torch.parallel.batch import (
        perturb_scenarios, solve_batch, summarize)
    from dcol_tpu_torch.systems import (
        cone_through_wall, piano_mover, quadrotor)
    from dcol_tpu_torch.utils import metrics

    mod = {"piano_mover": piano_mover, "quadrotor": quadrotor,
           "coneThroughWall": cone_through_wall}[args.system]
    if args.f32 or (args.device == "cuda" and not args.f64):
        dtype = torch.float32
    else:
        dtype = torch.float64
    sys_, params, X0, U0, cfg = mod.make_problem(dtype, args.device)

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    if args.batch:
        params_b, X0_b, U0_b = perturb_scenarios(
            params, X0, U0, n=args.batch, x0_sigma=0.02)
        sync()
        t0 = time.perf_counter()
        st = solve_batch(sys_, params_b, cfg, X0_b, U0_b)
        sync()
        print(f"batch of {args.batch} solved in "
              f"{time.perf_counter() - t0:.2f}s on {args.device}: "
              f"{summarize(st)}")
        return

    print(f"Starting ALTRO optimization ({args.system}, {dtype}, "
          f"{args.device})...")
    sync()
    t0 = time.perf_counter()
    st = solve_batch(sys_, {k: v[None] for k, v in params.items()}, cfg,
                     X0[None], U0[None])
    sync()
    wall = time.perf_counter() - t0
    print(metrics.iteration_table(st))
    print(f"ALTRO optimization complete in {wall:.2f}s "
          f"(converged={bool(st.converged[0])}, iters={int(st.iter[0])}).")


if __name__ == "__main__":
    main()
