"""The reduction of a profiled stretch's trace, on synthetic events."""

import pytest

from portbench.harness import roofline, trace


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(pdip_corr=7):
    return [
        _ev(trace.STRETCH, "user_annotation", 0.0, 1000.0),
        _ev("solver.rollout", "user_annotation", 10.0, 400.0),
        _ev("aten::mul", "cpu_op", 20.0, 30.0),
        _ev("cudaLaunchKernel", "cuda_runtime", 25.0, 5.0, corr=1),
        _ev("elementwise_kernel", "kernel", 40.0, 100.0, tid=9, corr=1),
        _ev("cudaStreamSynchronize", "cuda_runtime", 200.0, 50.0),
        _ev("scene.constraints", "user_annotation", 500.0, 400.0),
        _ev("cudaLaunchKernel", "cuda_runtime", 510.0, 5.0, corr=pdip_corr),
        _ev("void pdip_kernel<float, float, 4>", "kernel", 600.0, 200.0,
            tid=9, corr=7),
        _ev("cudaMemcpyAsync", "cuda_runtime", 850.0, 5.0),
        _ev("elementwise_kernel", "kernel", 2000.0, 5.0, tid=9),  # outside
    ]


def _launch():
    return [{"nv": 4, "n_ort": 12, "s1": 0, "s2": 0, "B": 1000,
             "start": "warm+skip", "iters": 3000.0, "skipped": 400}]


def test_counts_busy_and_gaps():
    r = trace.reduce(_events(), _launch())
    assert r["launches"] == 2 and r["syncs"] == 1
    assert not r["pdip_unseen"]
    assert r["busy_s"] == pytest.approx(300e-6)
    assert r["window_s"] == pytest.approx(1000e-6)
    gaps = dict(r["idle_gaps"])
    # gaps at 0-40 (the harness), 140-600 (the rollout's own code after its
    # launch) and 800-1000 (the constraints span)
    assert gaps == pytest.approx({"harness: python": 40e-6,
                                  "solver.rollout: python": 460e-6,
                                  "scene.constraints: python": 200e-6})
    assert r["device_ops"][0][0].startswith("void pdip_kernel")


def test_pdip_roofline_row():
    r = trace.reduce(_events(), _launch())
    (row,) = r["pdip"]
    want = roofline.launch(4, 12, 0, 0, "warm+skip", 1000, 3000.0, 400)
    assert row["bound_s"] == want["bound_s"]
    assert row["seconds"] == pytest.approx(200e-6)


def test_launches_unseen_by_the_runtime_trace_are_counted():
    r = trace.reduce(_events(pdip_corr=99), _launch())
    assert r["pdip_unseen"] and r["launches"] == 3


def test_stretch_span_required():
    with pytest.raises(RuntimeError):
        trace.reduce([_ev("x", "kernel", 0.0, 1.0)], [])


def test_per_layer_readers_on_a_reduced_trace():
    from portbench.harness.registry import Registry

    reg = Registry()
    red = trace.reduce(_events(), _launch())
    red.update(iters=2.0, unprofiled_wall_s=0.0008, unprofiled_iters=2.0)
    ctx = {"kind": "plan", "setup_s": 1.0, "trace": red,
           "window": {"work": 0.0, "elapsed": 0.0, "steps": 0}}
    got = {k: v["value"] for k, v in
           reg.read_metrics("quad_plan_1024", "per_layer", ctx).items()}
    assert got["host_launches_per_iter.plan"] == 1.0
    assert got["blocking_syncs_per_iter.plan"] == 0.5
    # 150 us busy of 400 us unprofiled wall per iteration
    assert got["device_idle_pct.plan"] == pytest.approx(62.5)
    bound = red["pdip"][0]["bound_s"]
    assert got["pdip_roofline.plan"] == pytest.approx(100 * bound / 200e-6)
    # a CPU run has no device trace: no device metric is read
    cpu = dict(red, busy_s=0.0, pdip=[])
    assert reg.read_metrics("quad_plan_1024", "per_layer",
                            dict(ctx, trace=cpu)) == {}
