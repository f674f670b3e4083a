"""The readers of the port's own counts (``pdip_iters_per_problem``,
``solver_syncs_per_iter``, ``scene_syncs_per_iter``) on a synthetic trace
context and recorder state."""

import sys

import pytest
import torch

from portbench.harness.registry import Registry

NAMES = ("pdip_iters_per_problem", "solver_syncs_per_iter",
         "scene_syncs_per_iter")


@pytest.fixture
def recorder():
    from dcol_tpu_torch.utils import trace

    rec = trace.RECORDER
    rec.clear()
    yield rec
    rec.clear()


def _ctx(iters=2.0, busy_s=0.1):
    return {"kind": "plan", "setup_s": 1.0,
            "window": {"work": 0.0, "elapsed": 0.0, "steps": 0},
            "trace": {"iters": iters, "busy_s": busy_s}}


def _fill(rec):
    rec.sync_counted = True
    rec.syncs.update({
        ("altro.iteration", "solver/altro.py:530"): 1,
        ("altro.rollout", "systems/quadrotor.py:39"): 6,
        ("mpc.tick", "solver/mpc.py:125"): 1,
        ("scene.assemble", "geometry/assembly.py:33"): 4,
        ("scene.solve", "systems/base.py:170"): 2})
    # two batches: 10 problems, 3 of them skipped, 21 iterations; and a
    # cold one of 4 problems, 20 iterations
    rec.pdip += [
        {"nv": 4, "n_ort": 6, "s1": 4, "s2": 0, "B": 10, "start": "warm+skip",
         "iters": torch.tensor(21),
         "skip": torch.tensor([True] * 3 + [False] * 7)},
        {"nv": 4, "n_ort": 6, "s1": 4, "s2": 0, "B": 4, "start": "cold",
         "iters": torch.tensor(20), "skip": None}]


def _read(name, ctx):
    return Registry().reader(name).read(ctx)


def test_readers_divide_the_port_counts(recorder):
    _fill(recorder)
    ctx = _ctx()
    assert _read("pdip_iters_per_problem.plan", ctx) == pytest.approx(41 / 11)
    assert _read("solver_syncs_per_iter.plan", ctx) == 4.0
    assert _read("scene_syncs_per_iter.mpc", ctx) == 3.0
    got = Registry().read_metrics("quad_plan_1024", "per_layer",
                                  dict(ctx, trace=dict(
                                      ctx["trace"], launches=0, syncs=0,
                                      pdip=[], unprofiled_iters=0)))
    assert {k: v["value"] for k, v in got.items()
            if k.split(".")[0] in NAMES} == pytest.approx({
                "pdip_iters_per_problem.plan": 41 / 11,
                "solver_syncs_per_iter.plan": 4.0,
                "scene_syncs_per_iter.plan": 3.0})
    assert got["solver_syncs_per_iter.plan"]["unit"] == "syncs/iter"


@pytest.mark.parametrize("name", NAMES)
def test_nothing_read_without_a_card_trace(recorder, name):
    _fill(recorder)
    assert _read(name, dict(_ctx(), trace=None)) is None
    assert _read(name, _ctx(busy_s=0.0)) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_read_from_an_empty_record(recorder, name):
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_read_from_a_port_without_the_record(recorder, name,
                                                     monkeypatch):
    _fill(recorder)
    # a port without ``utils.trace``: the import fails
    monkeypatch.setitem(sys.modules, "dcol_tpu_torch.utils.trace", None)
    assert _read(name, _ctx()) is None
