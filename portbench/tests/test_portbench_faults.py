"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, one that advances its count but
leaves the trajectories as they were, the dual and penalty update never
applied, half of each conic batch left out (the rest given the mean), an
answer altered where it is produced; and an MPC tick that applies the plan
it started from, unchanged."""

import time

import pytest

from portbench.harness import faults, runner
from portbench.tests.test_portbench_reference import PIANO_CELL, small_registry


def _run(tmp_path):
    reg = small_registry(tmp_path, PIANO_CELL, 3)
    return runner.run_cell(reg, PIANO_CELL, 4000000003, 2.0, False, "cpu",
                           time.perf_counter())


def test_sound_run_is_correct(tmp_path):
    assert _run(tmp_path)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "frozen", "no_dual",
                                   "half_batch", "altered"])
def test_fault_is_not_correct(tmp_path, fault):
    with faults.planted(fault):
        out = _run(tmp_path)
    assert not out["correct"], out["checks"]


def test_fault_is_restored(tmp_path):
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import base

    before = (altro.altro_iteration, base.solve_socp, base.solve_socp_cuda)
    with faults.planted("half_batch"), faults.planted("frozen"):
        assert altro.altro_iteration is not before[0]
    assert (altro.altro_iteration, base.solve_socp,
            base.solve_socp_cuda) == before


def test_stale_mpc_tick_is_not_correct(tmp_path):
    reg = small_registry(tmp_path, "quad_mpc_1024", 3, 12, warmup_ticks=1,
                         trace_tick=1)
    with faults.planted("frozen"):
        out = runner.run_cell(reg, "quad_mpc_1024", 4000000005, 0.5, False,
                              "cpu", time.perf_counter())
    assert not out["correct"]
    assert out["checks"]["stale_ticks"]["value"] == 1.0
