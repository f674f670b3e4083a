"""Command-line entry point of the port:

    python -m dcol_tpu_torch.main --system {quadrotor,piano_mover,coneThroughWall}
        [--batch N] [--f32 | --f64] [--device {cuda,cpu}] [--verbose]
        [--no-viz]

Runs on the card unless ``--device cpu`` is given (and raises where there
is none).  Without ``--batch`` it solves the system once, prints the
iteration table (live with ``--verbose``) and renders the diagnostic plots
and scene under ``result_images/<system>/`` unless ``--no-viz``; with
``--batch N`` it solves N perturbed scenarios and prints a summary.  The
default dtype is float32 on cuda and float64 on cpu.  :func:`main` returns
the solved state (batched, one scenario without ``--batch``).
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
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) needs a card")
    parser.add_argument("--no-viz", action="store_true",
                        help="skip the plots and scene renders")
    parser.add_argument("--verbose", action="store_true",
                        help="print the iteration table live (one host sync "
                             "per iteration) instead of after the solve")
    args = parser.parse_args(argv)

    from dcol_tpu_torch.parallel.batch import (
        perturb_scenarios, solve_batch, summarize)
    from dcol_tpu_torch.solver import altro
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

    if args.batch:
        params_b, X0_b, U0_b = perturb_scenarios(
            params, X0, U0, n=args.batch, x0_sigma=0.02)
        with metrics.Timer() as t:
            st = solve_batch(sys_, params_b, cfg, X0_b, U0_b)
        print(f"batch of {args.batch} solved in {t.elapsed:.2f}s on "
              f"{args.device}: {summarize(st)}")
        return st

    print(f"Starting ALTRO optimization ({args.system}, {dtype}, "
          f"{args.device})...")
    pb = {k: v[None] for k, v in params.items()}
    history, con_hist = [], []

    def keep(itr, st):
        # the X/U history of the per-iteration trajectory plots (reference
        # ALTRO.py:424-425) and each constraint's maximum over the horizon
        history.append((st.X[0].cpu(), st.U[0].cpu()))
        con_hist.append((st.hx[0].amax(dim=0).cpu(), st.hu[0].amax(dim=0).cpu()))

    t0 = time.perf_counter()
    if args.verbose or not args.no_viz:
        st = altro.solve_verbose(sys_, pb, cfg, X0[None], U0[None],
                                 callback=None if args.no_viz else keep,
                                 print_table=args.verbose)
    else:
        st = solve_batch(sys_, pb, cfg, X0[None], U0[None])
    metrics.block(st)
    wall = time.perf_counter() - t0
    if not args.verbose:
        print(metrics.iteration_table(st))
    print(f"ALTRO optimization complete in {wall:.2f}s "
          f"(converged={bool(st.converged[0])}, iters={int(st.iter[0])}).")

    if not args.no_viz:
        from dcol_tpu_torch.utils import plots, viz

        plots.plot_all(args.system, sys_, st)
        plots.plot_history(args.system, history, sys_.dt)
        if con_hist:
            plots.plot_per_constraint_violations(
                args.system, [hx for hx, _ in con_hist],
                [hu for _, hu in con_hist])
        viz.visualize_scene(args.system, sys_, params, st)
        print(f"Wrote plots + scene renders to result_images/{args.system}/")
    return st


if __name__ == "__main__":
    main()
