"""The nominal f32 piano's ALTRO iterations: the JAX package's on the CPU,
the port's plain version through its CLI, and the count that
``chip_smoke.py`` phase 13 holds the CLI's f32 piano on the card to
(``JAX_F32_PIANO_ITERS``, within ``F32_PIANO_ITERS_ATOL``).  The exact pin
on the card is the golden's float64 count, phase 13's ``--f64`` run."""

import contextlib
import io

import jax.numpy as jnp
import torch

import chip_smoke
from dcol_tpu.solver import altro as jaltro
from dcol_tpu.systems import piano_mover as jpiano
from dcol_tpu_torch import main as cli
from dcol_tpu_torch.systems import piano_mover

torch.set_num_threads(1)


def test_jax_f32_piano_count_is_the_ports_and_the_smokes():
    """The JAX package's f32 solve of the nominal piano (its CLI's
    ``--f32`` path, ``altro.solve``) and the port's CLI with ``--f32
    --device cpu --verbose --no-viz`` converge in the same iterations,
    which is the constant phase 13 holds the card to; the port reaches the
    goal within the golden test's 1e-4."""
    jsys, jparams, jX0, jU0, jcfg = jpiano.make_problem(dtype=jnp.float32)
    jst = jaltro.solve(jsys, jparams, jcfg, jX0, jU0)
    assert bool(jst.converged) and not bool(jst.failed)
    with contextlib.redirect_stdout(io.StringIO()):
        st = cli.main(["--system", "piano_mover", "--f32", "--device", "cpu",
                       "--verbose", "--no-viz"])
    assert st.X.dtype == torch.float32
    assert bool(st.converged[0]) and not bool(st.failed[0])
    xref = piano_mover.make_problem(torch.float32, "cpu")[1]["Xref"]
    assert float((st.X[0, -1] - xref[-1]).abs().max()) <= chip_smoke.GOAL_ATOL
    assert int(jst.iter) == int(st.iter[0]) == chip_smoke.JAX_F32_PIANO_ITERS
