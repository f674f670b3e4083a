"""The plain references against the port on the CPU, and the control
coming out not correct at a small size."""

import json
import os
import shutil
import time

import pytest
import torch

from portbench.harness import check, runner, socp
from portbench.harness.registry import BENCH_DIR, REPO, Registry

SYSTEMS = {"quad_hallway": "quadrotor", "piano_mover": "piano_mover"}


def _port(config):
    import importlib
    mod = importlib.import_module("dcol_tpu_torch.systems." + SYSTEMS[config])
    return mod.make_problem(torch.float64, "cpu")


@pytest.mark.parametrize("config", sorted(SYSTEMS))
def test_dynamics_match_the_port(config):
    ref = Registry().reference(config)
    sys_, params, X0, U0, _ = _port(config)
    g = torch.Generator().manual_seed(0)
    X = params["Xref"][:-1] + 0.3 * torch.randn(params["Xref"][:-1].shape,
                                                generator=g, dtype=torch.float64)
    U = U0 + 0.5 * torch.randn(U0.shape, generator=g, dtype=torch.float64)
    want = sys_.discrete_dynamics(params, X, U)
    got = ref.step(X, U, socp.REF)
    assert float((got - want).abs().max()) < 1e-12


@pytest.mark.parametrize("config", sorted(SYSTEMS))
def test_alpha_matches_the_port(config):
    reg = Registry()
    cfg, ref = reg.config(config), reg.reference(config)
    sys_, params, X0, U0, _ = _port(config)
    g = torch.Generator().manual_seed(1)
    X = params["Xref"][::4] + 0.3 * torch.randn(params["Xref"][::4].shape,
                                                generator=g, dtype=torch.float64)
    rs, ps = sys_.robot_pose(X[None])
    want = sys_.scene.alphas_traj(rs, ps, params["obs_r"][None],
                                  params["obs_p"][None])[0][0]
    got = check._alpha_ref(ref, cfg, X, socp.REF)
    # the port's float64 solve stops at mu < 1e-6
    assert float(((got - want).abs() / want.clamp(min=1)).max()) < 2e-5


def test_sphere_pair_closed_form():
    r1 = torch.tensor([[0.0, 0.0, 0.0], [1.0, 2.0, -1.0]], dtype=torch.float64)
    r2 = torch.tensor([[3.0, 0.0, 0.0], [1.0, 2.0, 3.0]], dtype=torch.float64)
    Q = torch.eye(3, dtype=torch.float64).expand(2, 3, 3)
    a = socp.alphas({"kind": "sphere", "R": 0.25}, [{"kind": "sphere", "R": 0.8}],
                    r1, Q, r2[:1] * 0 + torch.tensor([[3.0, 0, 0]]), Q[:1])
    assert float(a[0, 0]) == pytest.approx(3.0 / 1.05, rel=1e-9)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 3.14159265])
    r = socp.CONTROL.round(x)
    assert r[0] == 1.0 + 2.0 ** -10 or r[0] == 1.0  # ties away or even
    assert r[1] == 1.0 + 2.0 ** -10
    assert abs(float(r[2]) - 3.14159265) < 3.14159265 * 2.0 ** -11


# Limits of the small CPU runs: the plain float32 solver on 3 scenarios
# reads alpha_gap_p75 up to 3e-4 on the CPU (the kernel at the cell's size
# on the card: under 4e-6), so these tests hold the harness's logic, not
# the cell's limits
CPU_LIMITS = {"plan": {"dyn_gap": 1e-5, "alpha_gap_p75": 2e-3, "iter_gap": 0,
                       "violation": 0.3},
              "mpc": {"dyn_gap": 1e-5, "alpha_gap_p75": 2e-3,
                      "iters_over_cap": 0,
                      "plan_goal_gap": 10.0, "stale_ticks": 0.25}}

# A planning cell of the piano mover for the CPU runs: the plain solver
# finishes its batches there in seconds
PIANO_CELL = "piano_plan_cpu"


def small_registry(tmp_path, cell, scenarios, horizon=None, **mix_keys):
    """The benchmark with one cell's mix cut to ``scenarios`` (and
    ``mix_keys`` set) and the CPU runs' limits; ``PIANO_CELL`` is added
    as a cell of the piano mover under the planning mix."""
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    if cell == PIANO_CELL:
        bench["configs"].append({"name": "piano_mover", "source": "x",
                                 "file": "portbench/configs/piano_mover.json",
                                 "reduced": [], "why": "x"})
        bench["workloads"].append({"name": PIANO_CELL, "config": "piano_mover",
                                   "traffic": "plan_b1024", "chips": 1,
                                   "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(str(tmp_path / "portbench"))
    path = tmp_path / "portbench" / "mixes" / (reg.cell(cell)["traffic"]
                                               + ".json")
    mix = json.loads(path.read_text())
    mix["scenarios"], mix["judged"] = scenarios, scenarios
    if horizon:
        mix["horizon"] = horizon
    mix.update(mix_keys)
    path.write_text(json.dumps(mix))
    (tmp_path / "portbench" / "limits" / f"{cell}.json").write_text(
        json.dumps({"limits": CPU_LIMITS[mix["kind"]]}))
    return Registry(str(tmp_path / "portbench"))


@pytest.mark.parametrize("cell,seconds,horizon", [
    (PIANO_CELL, 3.0, None), ("quad_mpc_1024", 1.0, 12)])
def test_control_is_not_correct(tmp_path, cell, seconds, horizon):
    """The program passes its limits; the control, computed in TF32 in
    its place, fails at least one."""
    reg = small_registry(tmp_path, cell, 3, horizon)
    out = runner.run_cell(reg, cell, 2 ** 31 + 7, seconds, False, "cpu",
                          time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    nums = out["numbers"]
    failed = [k for k, c in out["checks"].items()
              if k + "_control" in nums and nums[k + "_control"] > c["limit"]]
    assert failed, nums
