"""Witness for the cone-through-wall batch: which of the 32 perturbed
scenarios converge in the JAX package, beside the port.

    python -m tests.test_torch_cone_witness [--port] [--seed S]
        [--dtype {float32,float64}] [--replicas N]

Solves the 32 ``perturb_scenarios(seed=S, x0_sigma=0.02)`` cone scenarios
(S = 0 and float32 unless told otherwise) with the JAX package on the CPU,
capped at CONE_MAX_ITERS ALTRO iterations as ``chip_smoke.py`` and
``dcol_tpu_torch.tools.hard_lanes`` cap the port's batch, and prints the
converged scenarios and iteration counts as one JSON line.  ``--port``
also runs the port's plain PDIP path on the CPU on the same scenarios.
``--replicas N``: the nominal problem replicated N times instead
(``x0_sigma=0``, as ``benchmarks/bench_systems.py`` runs the cone), and
whether every replica's X is bitwise the first's.  The run takes minutes, so it is a script; the test below only checks that
both packages start from the same f32 scenarios at seeds 0-2."""

import argparse
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcol_tpu.parallel import batch as jbatch
from dcol_tpu.systems import cone_through_wall as jcone
from dcol_tpu_torch.parallel import batch
from dcol_tpu_torch.systems import cone_through_wall
from dcol_tpu_torch.tools.hard_lanes import CONE_MAX_ITERS

N_SCENARIOS = 32


def _jax_problem(seed=0, dtype="float32", n=N_SCENARIOS, sigma=0.02):
    sys_, params, X0, U0, cfg = jcone.make_problem(dtype=getattr(jnp, dtype))
    pb, xb, ub = jbatch.perturb_scenarios(params, X0, U0, n=n,
                                          seed=seed, x0_sigma=sigma)
    return sys_, pb, xb, ub, dataclasses.replace(
        cfg, max_iters=CONE_MAX_ITERS)


def _port_problem(seed=0, dtype="float32", n=N_SCENARIOS, sigma=0.02):
    sys_, params, X0, U0, cfg = cone_through_wall.make_problem(
        getattr(torch, dtype), "cpu")
    pb, xb, ub = batch.perturb_scenarios(params, X0, U0, n=n,
                                         seed=seed, x0_sigma=sigma)
    return sys_, pb, xb, ub, dataclasses.replace(
        cfg, max_iters=CONE_MAX_ITERS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_witness_scenarios_match(seed):
    """The JAX package and the port perturb the same f32 scenarios."""
    _, jpb, jxb, jub, _ = _jax_problem(seed)
    _, pb, xb, ub, _ = _port_problem(seed)
    np.testing.assert_array_equal(np.asarray(jxb), xb.numpy())
    np.testing.assert_array_equal(np.asarray(jub), ub.numpy())
    for k in pb:
        np.testing.assert_array_equal(np.asarray(jpb[k]), pb[k].numpy())


def _summary(converged, iters, wall, X):
    conv = [int(i) for i in np.flatnonzero(np.asarray(converged))]
    X = np.asarray(X)
    return {"converged": len(conv), "of": len(X), "scenarios": conv,
            "iters": [int(i) for i in np.asarray(iters)], "wall_s": wall,
            "X_equal": bool((X == X[:1]).all())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", action="store_true",
                    help="also solve through the port's plain version")
    ap.add_argument("--seed", type=int, default=0,
                    help="perturb_scenarios seed (default 0)")
    ap.add_argument("--replicas", type=int, metavar="N",
                    help="the nominal problem replicated N times instead")
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32")
    args = ap.parse_args(argv)
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    tag = "f32" if args.dtype == "float32" else "f64"
    out = {"max_iters": CONE_MAX_ITERS, "seed": args.seed}
    shape = ({} if args.replicas is None
             else {"n": args.replicas, "sigma": 0.0})
    out.update(shape)
    sys_, pb, xb, ub, cfg = _jax_problem(args.seed, args.dtype, **shape)
    t0 = time.perf_counter()
    st = jbatch.solve_batch(sys_, pb, cfg, xb, ub)
    out[f"jax_{tag}_cpu"] = _summary(st.converged, st.iter,
                                     time.perf_counter() - t0, st.X)
    if args.port:
        sys_, pb, xb, ub, cfg = _port_problem(args.seed, args.dtype,
                                              **shape)
        t0 = time.perf_counter()
        st = batch.solve_batch(sys_, pb, cfg, xb, ub)
        out[f"port_plain_{tag}_cpu"] = _summary(st.converged.numpy(),
                                                st.iter.numpy(),
                                                time.perf_counter() - t0,
                                                st.X.numpy())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
