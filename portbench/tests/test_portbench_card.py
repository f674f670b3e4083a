"""On the card, at each cell's own size: the control comes out not
correct against the cell's limits while the program's run passes, and a
run with a fault planted in the timed path comes out not correct."""

import time

import pytest

from portbench.control import control_judged
from portbench.harness import faults, runner
from portbench.harness.registry import Registry

# (cell, window seconds): long enough to judge a step of the window
CELLS = [("quad_plan_1024", 5.0), ("quad_mpc_1024", 3.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", CELLS)
def test_control_fails_at_the_cells_size(card, cell, seconds):
    out = runner.run_cell(Registry(), cell, 3000000011, seconds, False, card,
                          time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    ok, compared = control_judged(out)
    assert not ok, compared


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds,fault", [
    ("quad_plan_1024", 5.0, "frozen"), ("quad_plan_1024", 5.0, "no_dual"),
    ("quad_mpc_1024", 3.0, "frozen")])
def test_fault_fails_at_the_cells_size(card, cell, seconds, fault):
    with faults.planted(fault):
        out = runner.run_cell(Registry(), cell, 3000000013, seconds, False,
                              card, time.perf_counter())
    assert not out["correct"], out["checks"]
