"""Per-member failure isolation in the port's scenario batch (float64 on the
CPU), mirroring tests/test_robustness.py:39: a NaN initial state fails only
its own batch member, and its neighbours come out bitwise as in the clean
batch."""

import math

import torch

from dcol_tpu_torch.parallel.batch import perturb_scenarios, solve_batch
from dcol_tpu_torch.systems import piano_mover

torch.set_num_threads(1)


def test_poisoned_member_does_not_contaminate_batch():
    sys_, params, X0, U0, cfg = piano_mover.make_problem(torch.float64, "cpu")
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=4, seed=3,
                                   x0_sigma=0.03)
    clean = solve_batch(sys_, pb, cfg, xb, ub)
    assert bool(clean.converged.all())

    xp = xb.clone()
    xp[2, 0, 0] = math.nan
    poisoned = solve_batch(sys_, pb, cfg, xp, ub)
    assert not bool(poisoned.converged[2])
    assert bool(poisoned.failed[2])
    for i in (0, 1, 3):
        assert bool(poisoned.converged[i])
        assert int(poisoned.iter[i]) == int(clean.iter[i])
        assert torch.equal(poisoned.X[i], clean.X[i])
        assert torch.equal(poisoned.U[i], clean.U[i])
