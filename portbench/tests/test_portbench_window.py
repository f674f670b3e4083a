"""Window arithmetic on synthetic timestamps, and the roofline share of
one launch against the port's own accounting at this commit."""

import pytest
import torch

from portbench.harness import roofline, window


def test_rate_counts_the_step_that_straddles_the_end():
    # window [10, 20): steps end at 13, 17, 21 (started at 17 < 20: counted),
    # 24 (started at 21: not counted)
    steps = [(13.0, 1024), (17.0, 1000), (21.0, 990), (24.0, 980)]
    work, elapsed, n = window.rate(10.0, 10.0, steps)
    assert (work, elapsed, n) == (3014.0, 11.0, 3)


def test_rate_active_counts_fall_as_scenarios_finish():
    steps = [(1.0, 4), (2.0, 3), (3.0, 1)]
    assert window.rate(0.0, 100.0, steps) == (8.0, 3.0, 3)
    assert window.rate(0.0, 0.5, steps) == (4.0, 1.0, 1)
    assert window.rate(0.0, 1.0, []) == (0.0, 0.0, 0)


def test_tick_period():
    ends = [2.5, 5.0, 7.6]
    assert window.counted(0.0, 6.0, ends) == 3
    assert window.counted(0.0, 5.0, ends) == 2


def test_union_gaps_and_idle():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7)]
    assert window.union_seconds(iv) == 3.0
    assert window.gaps(iv) == [(2.0, 3.0)]
    assert window.idle_pct(3.0, 4.0) == pytest.approx(25.0)


@pytest.mark.parametrize("start,iters,skip", [
    ("cold", 12.0 * 100, 0), ("warm", 3.0 * 100, 0),
    ("warm+skip", 2.0 * 100, 37)])
def test_launch_matches_the_ports_account(start, iters, skip):
    """The frozen arithmetic and FLOP table give the port's
    ``roofline.account`` on the same inputs (the piano's layout)."""
    from dcol_tpu_torch.ops.cones import ConeLayout
    from dcol_tpu_torch.tools import roofline as port

    ms = 0.05
    want = port.account(4, ConeLayout(12, 0, 0), start, 100, ms, iters, skip)
    got = roofline.launch(4, 12, 0, 0, start, 100, iters, skip)
    assert got["flops"] == want["flops"]
    assert got["bytes"] == want["bytes"]
    assert got["bound_s"] * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)


def test_flop_table_is_the_ports_tally():
    """One row of the stored table against ``pdip_work`` at this commit."""
    from dcol_tpu_torch.ops.cones import ConeLayout
    from dcol_tpu_torch.tools import roofline as port

    for warm in (False, True):
        want = port.pdip_work(4, ConeLayout(1, 4, 3), torch.float32, warm)
        assert roofline.work(4, 1, 4, 3, warm) == want
