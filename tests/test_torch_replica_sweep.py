"""``tools/replicas.py --sweep`` on the CPU at its small size (3 replicas,
12 knots, 2 ALTRO iterations, 2 MPC ticks): each system's entry keeps
every member equal, and the stage probe names the step that parts when
one op is made to round a member otherwise."""

import dataclasses

import pytest
import torch

from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.tools import replicas

torch.set_num_threads(1)

SMALL = {e.system: replicas.small(e) for e in reversed(replicas.SWEEP)}


@pytest.mark.parametrize("system", sorted(SMALL))
def test_sweep_small_on_cpu(system):
    """``replicas --sweep --small --device cpu``'s entry of each system (3
    replicas, 12 knots, 2 ALTRO iterations; the MPC 2 ticks): every member
    equal in every field."""
    row = replicas.run_entry(SMALL[system], torch.device("cpu"),
                             out=lambda *a: None)
    assert row["n"] == 3 and row["iters_equal"]
    assert row["X_parted"] == 0 and not any(row["fields_parted"].values())
    assert row["failures"] == [] and "located" not in row


@pytest.mark.parametrize("system", ["coneThroughWall", "mpc"])
def test_locate_names_the_op_that_parts(monkeypatch, system):
    """With dynamics Jacobians that round member 1 otherwise (as an op
    that rounds by batch position does), the sweep's entry fails and the
    stage probe finds the first iteration (of the first MPC tick) parted
    and names the Jacobians as the first step that parts."""
    jacobians = altro.dynamics_jacobians

    def parting(*args):
        A, B = jacobians(*args)
        member = (torch.arange(A.shape[0]) == 1).reshape(-1, 1, 1, 1)
        return A + member * A * 1e-6, B

    monkeypatch.setattr(altro, "dynamics_jacobians", parting)
    e = dataclasses.replace(SMALL[system], ticks=min(SMALL[system].ticks, 1))
    row = replicas.run_entry(e, torch.device("cpu"), out=lambda *a: None)
    assert row["failures"] and row["X_parted"] > 0
    loc = row["located"]
    assert loc["iteration"] == 0 and loc.get("tick", 0) == 0
    assert loc["first"] == "dynamics Jacobians: A", loc["first"]
