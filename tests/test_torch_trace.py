"""The port's tracing (``dcol_tpu_torch.utils.trace``) on one ALTRO
iteration of the f64 piano mover: nothing recorded and no profiler call
without a profiler; the spans' nesting in an exported trace and the conic
batches' counts under one; the counts of one profiled stretch only; the
synchronisations counted by span and call site (CUDA's sync debug mode
stood in for on the CPU); the rollouts by path; and, on a card, the count
against the trace."""

import inspect
import json
import os
import sys
import warnings

import pytest
import torch

from dcol_tpu_torch.ops import pdip_cuda
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.systems import base, piano_mover
from dcol_tpu_torch.utils import trace

torch.set_num_threads(1)

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


class _Stop(Exception):
    pass


def _one_iteration(sys_, params, cfg, st):
    """``st`` after one pass of ``altro.iterate``."""
    def cb(itr, s):
        raise _Stop(s)
    try:
        altro.iterate(sys_, params, cfg, st, callback=cb)
    except _Stop as e:
        return e.args[0]
    raise AssertionError("iterate returned before one iteration")


@pytest.fixture(scope="module")
def piano():
    """(system, params, cfg, initial state) of one f64 piano scenario."""
    sys_, params, X0, U0, cfg = piano_mover.make_problem(torch.float64, "cpu")
    pb = {k: v[None] for k, v in params.items()}
    st = altro.make_initial_state(sys_, pb, cfg, X0[None], U0[None])
    return sys_, pb, cfg, st


@pytest.fixture(autouse=True)
def _fresh_recorder():
    trace.RECORDER.clear()
    yield
    trace.RECORDER.clear()


def _profiled(fn, tmp_path=None):
    """(fn's result, the exported trace's complete events or None)."""
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        out = fn()
    if tmp_path is None:
        return out, None
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return out, [e for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X"]


def _solutions(monkeypatch):
    """Record (B, skip, SocpSolution) of every plain conic solve."""
    seen = []
    plain = base.solve_socp

    def solve(c, G, h, lay, **kw):
        sol = plain(c, G, h, lay, **kw)
        seen.append((c.shape[0], kw.get("skip"), sol))
        return sol
    monkeypatch.setattr(base, "solve_socp", solve)
    return seen


def test_unprofiled_step_records_nothing(piano, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not trace.recording()
    assert trace.span("altro.iteration") is trace.OFF
    assert trace.span("scene.solve") is trace.OFF
    _one_iteration(*piano)
    assert trace.RECORDER.pdip == [] and not trace.RECORDER.syncs
    assert not trace.RECORDER.sync_counted


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_profiled_step_spans_and_conic_counts(piano, monkeypatch, tmp_path):
    sys_, pb, cfg, st = piano
    seen = _solutions(monkeypatch)

    def step():
        altro.make_initial_state(sys_, pb, cfg, st.X, st.U)
        return _one_iteration(*piano)
    _, events = _profiled(step, tmp_path)
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] in trace.SPANS]
    names = {e["name"] for e in spans}
    assert names == set(trace.SPANS) - {"mpc.tick"}
    by = lambda n: [e for e in spans if e["name"] == n]
    (it,) = by("altro.iteration")
    (polish,) = by("altro.backward.polish")
    (probe,) = by("altro.forward.probe")
    assert _inside(polish, it) and _inside(probe, it)
    assert any(_inside(s, polish) for s in by("scene.solve"))
    assert any(_inside(r, probe) for r in by("altro.rollout"))
    assert _inside(by("scene.envelope")[0], polish)
    # every conic batch the scene solved, with B > 0, noted as solved
    rec = trace.RECORDER.pdip
    assert len(rec) == len(seen) > 0
    starts = [r["start"] for r in rec]
    assert starts[0] == "cold" and "warm+skip" in starts
    totals = trace.RECORDER.pdip_totals()
    problems = sum(B - (0 if sk is None else int(sk.sum()))
                   for B, sk, _ in seen)
    iters = sum(int(sol.iters.sum()) for _, _, sol in seen)
    assert sum(t["problems"] for t in totals.values()) == problems
    assert sum(t["iters"] for t in totals.values()) == iters
    assert sum(t["batches"] for t in totals.values()) == len(seen)
    assert not trace.RECORDER.sync_counted      # no card: no sync count
    assert trace.RECORDER.layer_syncs("solver") is None
    # the initial rollout and one a rollout span, all the loop's on the CPU
    assert trace.RECORDER.rollouts == {"loop": 1 + len(by("altro.rollout"))}


def test_counts_of_the_latest_profiled_stretch_only(piano):
    _profiled(lambda: _one_iteration(*piano))
    first = trace.RECORDER.pdip_totals()
    assert first
    # a second stretch straight after adds to the first ...
    _profiled(lambda: _one_iteration(*piano))
    twice = trace.RECORDER.pdip_totals()
    assert all(twice[k]["iters"] == 2 * v["iters"] for k, v in first.items())
    # ... but one after an unprofiled step starts afresh
    _one_iteration(*piano)
    assert trace.RECORDER.pdip_totals() == twice
    _profiled(lambda: _one_iteration(*piano))
    assert trace.RECORDER.pdip_totals() == first


def _line_of(fn, text):
    """``file:line`` (package-relative) of the line of ``fn`` holding
    ``text``."""
    lines, start = inspect.getsourcelines(fn)
    (i,) = [i for i, ln in enumerate(lines) if text in ln]
    rel = os.path.relpath(inspect.getsourcefile(fn),
                          os.path.dirname(os.path.dirname(trace.__file__)))
    return f"{rel.replace(os.sep, '/')}:{start + i}"


def test_syncs_counted_by_span_and_site(piano, monkeypatch, capfd,
                                        recwarn):
    """CUDA's sync debug mode stood in for: each ``bool`` of a tensor
    warns as the mode does for a card's synchronisation, and setting the
    mode warns that it is a prototype."""
    modes = []

    def set_mode(mode):
        warnings.warn(trace.PROTOTYPE_MESSAGE + " (stand-in)", UserWarning)
        modes.append(mode)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    as_bool = torch._C.TensorBase.__bool__

    def synced_bool(self):
        warnings.warn(trace.SYNC_MESSAGE + " (stand-in)", UserWarning)
        return as_bool(self)
    monkeypatch.setattr(torch.Tensor, "__bool__", synced_bool)
    filters, shown = list(warnings.filters), warnings.showwarning

    _profiled(lambda: _one_iteration(*piano))
    syncs = trace.RECORDER.syncs
    assert syncs[("altro.iteration",
                  _line_of(altro.iterate, "bool(active.any())"))] == 1
    assert syncs[("altro.forward.chunk",
                  _line_of(altro.forward_pass, "bool(found.all())"))] == 1
    assert all(site.split(":")[0].endswith(".py") for _, site in syncs)
    total = sum(syncs.values())
    assert (trace.RECORDER.layer_syncs("solver")
            + trace.RECORDER.layer_syncs("scene")) == total
    assert trace.RECORDER.layer_syncs("scene") == sum(
        n for (name, _), n in syncs.items() if name.startswith("scene."))
    # the mode on for the one outermost span, then restored; the warnings
    # machinery restored and nothing shown
    assert modes == ["warn", 0]
    assert warnings.filters == filters and warnings.showwarning is shown
    err = capfd.readouterr().err
    assert trace.SYNC_MESSAGE not in err and trace.PROTOTYPE_MESSAGE not in err
    assert not [w for w in recwarn if trace.SYNC_MESSAGE in str(w.message)
                or trace.PROTOTYPE_MESSAGE in str(w.message)]
    # outside a profiled span the stand-in warns as usual
    with pytest.warns(UserWarning, match=trace.SYNC_MESSAGE):
        bool(torch.ones(1))


def test_coverage_of_a_synthetic_trace():
    def ev(name, cat, ts, dur, tid=1):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "tid": tid}
    events = [
        ev("altro.iteration", "user_annotation", 100.0, 700.0),
        ev("scene.solve", "user_annotation", 300.0, 100.0),
        ev("harness", "user_annotation", 0.0, 1000.0),
        ev("cudaLaunchKernel", "cuda_runtime", 50.0, 5.0),       # outside
        ev("cudaLaunchKernel", "cuda_runtime", 150.0, 5.0),
        ev("cudaLaunchKernel", "cuda_runtime", 350.0, 5.0),
        ev("cudaStreamSynchronize", "cuda_runtime", 360.0, 20.0),
        ev("cudaStreamSynchronize", "cuda_runtime", 900.0, 20.0),  # outside
        ev("kernel_a", "kernel", 200.0, 100.0, tid=7),
        ev("kernel_b", "kernel", 400.0, 500.0, tid=7),
    ]
    cov = trace.coverage(events, 0.0, 1000.0)
    # idle 0-200, 300-400, 900-1000; port spans hold 100-200 and 300-400
    assert cov["idle_us"] == 400.0 and cov["idle_in_spans_us"] == 200.0
    assert (cov["launches"], cov["launches_in_spans"]) == (3, 2)
    assert (cov["syncs"], cov["syncs_in_spans"]) == (2, 1)


@pytest.mark.cuda
def test_card_syncs_match_the_trace(tmp_path):
    """The quadrotor at S = 4, f32, on the card: one iteration profiled
    after one unprofiled; the syncs the port counted equal the runtime's
    synchronisations inside port spans in the trace, and the quadrotor's
    constants copied to the card each RK4 stage are among the sites."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dcol_tpu_torch.systems import quadrotor

    sys_, params, X0, U0, cfg = quadrotor.make_problem(torch.float32, "cuda")
    S = 4
    pb = {k: v[None].expand((S,) + v.shape).contiguous()
          for k, v in params.items()}
    st = altro.make_initial_state(sys_, pb, cfg, X0[None].expand(S, *X0.shape),
                                  U0[None].expand(S, *U0.shape).contiguous())
    _one_iteration(sys_, pb, cfg, st)
    torch.cuda.synchronize()
    n0 = pdip_cuda.launches
    with torch.profiler.profile(activities=CPU_ONLY + [
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _one_iteration(sys_, pb, cfg, st)
        torch.cuda.synchronize()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    cov = trace.coverage(events, t0, t1)
    rec = trace.RECORDER
    assert rec.sync_counted
    assert sum(rec.syncs.values()) == cov["syncs_in_spans"] > 0
    sites = {site for _, site in rec.syncs}
    assert {"systems/quadrotor.py:39", "systems/quadrotor.py:50"} <= sites
    assert len(rec.pdip) == pdip_cuda.launches - n0
    # the quadrotor's rollouts run as the kernel on the card, none the loop
    assert rec.rollouts["kernel"] > 0 and rec.rollouts["loop"] == 0
    assert cov["launches_in_spans"] >= 0.99 * cov["launches"]
    assert torch.cuda.get_sync_debug_mode() == 0
    print(json.dumps({"syncs": {f"{k[0]} {k[1]}": n
                                for k, n in rec.syncs.items()},
                      "coverage": cov, "pdip": rec.pdip_totals()}),
          file=sys.stderr)
