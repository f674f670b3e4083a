"""Witness for the f32 cone-through-wall batch: which of the 32 perturbed
scenarios converge in the JAX package, beside the port.

    python -m tests.test_torch_cone_witness [--port]

Solves the 32 ``perturb_scenarios(seed=0, x0_sigma=0.02)`` f32 cone
scenarios with the JAX package on the CPU, capped at CONE_F32_MAX_ITERS
ALTRO iterations as ``chip_smoke.py`` caps the port's batch, and prints the
converged scenarios and iteration counts as one JSON line.  ``--port``
also runs the port's plain PDIP path on the CPU on the same scenarios.
The run takes minutes, so it is a script; the test below only checks that
both packages start from the same f32 scenarios."""

import dataclasses
import json
import sys
import time

import numpy as np
import torch

import jax.numpy as jnp

from chip_smoke import CONE_F32_MAX_ITERS
from dcol_tpu.parallel import batch as jbatch
from dcol_tpu.systems import cone_through_wall as jcone
from dcol_tpu_torch.parallel import batch
from dcol_tpu_torch.systems import cone_through_wall

N_SCENARIOS = 32


def _jax_problem():
    sys_, params, X0, U0, cfg = jcone.make_problem(dtype=jnp.float32)
    pb, xb, ub = jbatch.perturb_scenarios(params, X0, U0, n=N_SCENARIOS,
                                          seed=0, x0_sigma=0.02)
    return sys_, pb, xb, ub, dataclasses.replace(
        cfg, max_iters=CONE_F32_MAX_ITERS)


def _port_problem():
    sys_, params, X0, U0, cfg = cone_through_wall.make_problem(torch.float32,
                                                               "cpu")
    pb, xb, ub = batch.perturb_scenarios(params, X0, U0, n=N_SCENARIOS,
                                         seed=0, x0_sigma=0.02)
    return sys_, pb, xb, ub, dataclasses.replace(
        cfg, max_iters=CONE_F32_MAX_ITERS)


def test_witness_scenarios_match():
    """The JAX package and the port perturb the same f32 scenarios."""
    _, jpb, jxb, jub, _ = _jax_problem()
    _, pb, xb, ub, _ = _port_problem()
    np.testing.assert_array_equal(np.asarray(jxb), xb.numpy())
    np.testing.assert_array_equal(np.asarray(jub), ub.numpy())
    for k in pb:
        np.testing.assert_array_equal(np.asarray(jpb[k]), pb[k].numpy())


def _summary(converged, iters, wall):
    conv = [int(i) for i in np.flatnonzero(np.asarray(converged))]
    return {"converged": len(conv), "of": N_SCENARIOS, "scenarios": conv,
            "iters": [int(i) for i in np.asarray(iters)], "wall_s": wall}


def main(argv):
    out = {"max_iters": CONE_F32_MAX_ITERS}
    sys_, pb, xb, ub, cfg = _jax_problem()
    t0 = time.perf_counter()
    st = jbatch.solve_batch(sys_, pb, cfg, xb, ub)
    out["jax_f32_cpu"] = _summary(st.converged, st.iter,
                                  time.perf_counter() - t0)
    if "--port" in argv:
        sys_, pb, xb, ub, cfg = _port_problem()
        t0 = time.perf_counter()
        st = batch.solve_batch(sys_, pb, cfg, xb, ub)
        out["port_plain_f32_cpu"] = _summary(st.converged.numpy(),
                                             st.iter.numpy(),
                                             time.perf_counter() - t0)
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
