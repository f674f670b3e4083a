"""The port's host side on the CPU, mirroring tests/test_utils.py: the plot
and scene files, polytope vertices and MRP angles against the JAX package,
solve_verbose's callback, batch_summary_json against the JAX package's, the
metrics helpers, the CLI with and without plots, and the profiling tool's
component callables."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcol_tpu.utils import metrics as jmetrics
from dcol_tpu.utils import plots as jplots
from dcol_tpu.utils import viz as jviz
from dcol_tpu_torch import main as cli
from dcol_tpu_torch.geometry import primitives as prim
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.systems import piano_mover, quadrotor
from dcol_tpu_torch.tools import profile_breakdown
from dcol_tpu_torch.utils import metrics, plots, trace, viz

torch.set_num_threads(1)

F64 = torch.float64


@pytest.fixture(scope="module")
def piano3():
    """The f64 piano through solve_verbose, capped at 3 iterations, with
    the (itr, X) of every callback."""
    import dataclasses

    sys_, params, X0, U0, cfg = piano_mover.make_problem(F64, "cpu")
    cfg = dataclasses.replace(cfg, max_iters=3)
    seen = []
    st = altro.solve_verbose(
        sys_, {k: v[None] for k, v in params.items()}, cfg, X0[None],
        U0[None], print_table=False,
        callback=lambda itr, s: seen.append((itr, s.X.clone())))
    return sys_, params, st, seen


def test_iteration_table(piano3):
    """A row an iteration under the two header lines."""
    _, _, st, _ = piano3
    table = metrics.iteration_table(st).splitlines()
    assert len(table) == int(st.iter[0]) + 2 and table[-1].startswith("  3 ")


def test_per_constraint_violation_plots(tmp_path, monkeypatch):
    """tests/test_utils.py:29-40, from tensors."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(1)
    hx_hist = torch.tensor(rng.normal(size=(15, 3)))
    hu_hist = torch.tensor(rng.normal(size=(15, 6)))
    plots.plot_per_constraint_violations("piano_mover", hx_hist, hu_hist)
    d = os.path.join(tmp_path, "result_images", "piano_mover")
    assert os.path.exists(os.path.join(d, "state_constraints.png"))
    assert os.path.exists(os.path.join(d, "control_constraints.png"))


def test_viz_3d_all_primitives(tmp_path, monkeypatch):
    """The 3-D renderer draws every primitive kind of the quadrotor scene
    in its three views (tests/test_utils.py:42-51)."""
    monkeypatch.chdir(tmp_path)
    sys_, params, X0, U0, cfg = quadrotor.make_problem(F64, "cpu", N=10)
    X = X0[0].expand(10, -1)
    for view in ("side_az_90", "top_down", "custom"):
        viz.visualize_scene_3d("quadrotor", sys_, params, X, view_mode=view)
        assert os.path.exists(os.path.join(
            tmp_path, "result_images", "quadrotor", f"scene_{view}.png"))


def test_polytope_vertex_enumeration():
    """tests/test_utils.py:53-59, and equal to the JAX package's vertices
    for every polytope of the quadrotor scene."""
    shape = prim.rect_prism(2.0, 4.0, 6.0)
    V = viz.polytope_vertices(shape.A_np(), shape.b_np())
    assert V.shape == (8, 3)
    np.testing.assert_allclose(np.abs(V).max(axis=0), [1.0, 2.0, 3.0])
    sys_ = quadrotor.make_system(N=10)
    polys = [o for o in sys_.scene.obstacles if o.kind == prim.POLYTOPE]
    assert polys
    for o in polys:
        np.testing.assert_array_equal(
            viz.polytope_vertices(o.A_np(), o.b_np()),
            jviz.polytope_vertices(o.A_np(), o.b_np()))


def test_trajectory_history_plots(tmp_path, monkeypatch):
    """Four state panels and each system's control splits, every 10
    iterations and the last (tests/test_utils.py:62-91, with 11 iterations
    for 12), from tensors."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    cases = {
        "piano_mover": (6, 3, ["linear_acceleration", "angular_acceleration"]),
        "quadrotor": (12, 4, ["control_trajectories"]),
        "coneThroughWall": (12, 6, ["forces", "torques"]),
    }
    for system, (nx, nu, control_stems) in cases.items():
        hist = [(torch.tensor(rng.normal(size=(20, nx))),
                 torch.tensor(rng.normal(size=(19, nu)))) for _ in range(11)]
        plots.plot_history(system, hist, dt=0.1, every=10)
        d = os.path.join(tmp_path, "result_images", system)
        for it in (0, 10):
            for stem in ["position", "velocity", "orientation",
                         "angular_velocity"]:
                f = os.path.join(d, "state_trajectories_history",
                                 f"{stem}_iter_{it}.png")
                assert os.path.exists(f), f
            for stem in control_stems:
                f = os.path.join(d, "control_trajectories_history",
                                 f"{stem}_iter_{it}.png")
                assert os.path.exists(f), f
        assert not os.path.exists(os.path.join(
            d, "state_trajectories_history", "position_iter_5.png"))


def test_solve_verbose_callback_captures_history(piano3):
    """The callback runs once an iteration with the batched state
    (tests/test_utils.py:93-105)."""
    _, _, st, seen = piano3
    assert [i for i, _ in seen] == [0, 1, 2]
    assert torch.equal(seen[-1][1], st.X)


def test_mrp_to_euler_roundtrip():
    """tests/test_utils.py:108-111, and equal to the JAX package's angles
    on random MRPs."""
    p = torch.tensor([0.0, 0.0, np.tan(np.deg2rad(90) / 4)])
    np.testing.assert_allclose(np.rad2deg(plots.mrp_to_euler(p)), [0, 0, 90],
                               atol=1e-9)
    q = np.random.default_rng(2).normal(0, 0.3, (50, 3))
    np.testing.assert_array_equal(plots.mrp_to_euler(torch.tensor(q)),
                                  jplots.mrp_to_euler(q))


def test_batch_summary_json_matches_jax(piano3):
    """The port's summary line has the JAX package's keys and values on the
    same batch."""
    _, _, st, _ = piano3
    st = altro.tree_map(lambda a: torch.cat([a, a]), st)
    st = st._replace(converged=torch.tensor([True, False]),
                     iter=torch.tensor([3, 7], dtype=torch.int32))
    jst = type("S", (), {k: jnp.asarray(getattr(st, k).numpy()) for k in
                         ("converged", "failed", "iter", "convio")})
    got = json.loads(metrics.batch_summary_json(st, 0.5))
    want = json.loads(jmetrics.batch_summary_json(jst, 0.5))
    assert got == want


def test_metrics_timer_block_throughput_trace(tmp_path):
    x = torch.ones(3)
    assert metrics.block({"a": (x, [x])}) is not None
    with metrics.Timer() as t:
        y = x + 1
    assert t.elapsed >= 0.0 and torch.equal(y, x + 1)
    with trace.trace(str(tmp_path)):
        (x * 3).sum()
    assert os.path.exists(os.path.join(tmp_path, trace.TRACE_FILE))


def test_cli_verbose_no_viz(tmp_path, monkeypatch, capsys):
    """--verbose prints the table live and reports the piano's 35
    iterations; --no-viz writes nothing."""
    monkeypatch.chdir(tmp_path)
    cli.main(["--system", "piano_mover", "--device", "cpu", "--verbose",
              "--no-viz"])
    assert os.listdir(tmp_path) == []
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == "Convergence reached in 35 iterations."
    assert "(converged=True, iters=35)" in out[-1]
    assert sum(ln.startswith(" 35 ") for ln in out) == 1


def test_cli_plots(tmp_path, monkeypatch, capsys):
    """Without --no-viz the CLI writes plot_all's and visualize_scene's
    files (tests/test_utils.py:13-27), the history and the per-constraint
    curves under result_images/<system>/, after the table."""
    monkeypatch.chdir(tmp_path)
    cli.main(["--system", "piano_mover", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert "(converged=True, iters=35)" in out[-2]
    assert out[-3].startswith(" 35 ")
    d = os.path.join(tmp_path, "result_images", "piano_mover")
    for f in ["regularization.png", "constraint_violations.png",
              "trajectories.png", "scene_topdown.png", "state_constraints.png",
              "control_constraints.png", os.path.join("costs", "cost.png"),
              os.path.join("state_trajectories_history",
                           "position_iter_34.png"),
              os.path.join("control_trajectories_history",
                           "linear_acceleration_iter_30.png")]:
        assert os.path.exists(os.path.join(d, f)), f


def test_cli_needs_a_card():
    """The CLI runs on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="not available"):
        cli.main(["--system", "piano_mover", "--no-viz"])


def test_profile_components_run_on_cpu():
    """Each of profile_breakdown's component callables runs once at N=10,
    batch 2, on the CPU (untimed: times come from the card)."""
    sys_, params_b, cfg, st = profile_breakdown.setup(2, "cpu", N=10,
                                                      advance_iters=1)
    comps = profile_breakdown.components(sys_, params_b, cfg, st)
    assert list(comps) == [
        "full_iteration", "backward_pass", "forward_pass",
        "constraints_solve_warm", "constraints_solve_cold",
        "constraints_vg_warm", "envelope_grads_only", "rollout_1alpha",
        "dynamics_jacobians"]
    out = {name: fn() for name, fn in comps.items()}
    assert out["full_iteration"].X.shape == st.X.shape
    hx = out["constraints_solve_cold"]
    torch.testing.assert_close(out["constraints_solve_warm"], hx, rtol=0,
                               atol=1e-3)
    assert out["constraints_vg_warm"][1].shape == hx.shape + (sys_.nx,)
    assert out["envelope_grads_only"][0].shape == hx.shape + (3,)
    assert out["rollout_1alpha"][0].shape == (2, 1) + st.X.shape[1:]
    assert out["dynamics_jacobians"][0].shape == (2, 9, sys_.nx, sys_.nx)


def test_profile_breakdown_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="not available"):
        profile_breakdown.main([])
