"""Discovery of the benchmark's pieces by name."""

import json
import os
import shutil

import pytest

from portbench.harness.registry import BENCH_DIR, REPO, Registry


def test_every_cell_finds_its_pieces():
    reg = Registry()
    for w in reg.bench["workloads"]:
        config = reg.config(w["config"])
        assert config["name"] == w["config"]
        assert reg.reference(w["config"]).dt == config["dt"]
        assert reg.mix(w["traffic"])["kind"] in ("plan", "mpc")
        assert "limits" in reg.limits(w["name"])
        for section in ("end_to_end", "per_layer"):
            for m in reg.metrics_of(w["name"], section):
                assert callable(reg.reader(m["name"]).read)


def test_split_metric_finds_the_quantity_reader():
    reg = Registry()
    a = reg.reader("device_idle_pct.plan")
    assert a.__file__.endswith(os.path.join("metrics", "device_idle_pct.py"))


def test_cells_report_their_metrics():
    reg = Registry()
    e2e = {m["name"] for m in reg.metrics_of("quad_plan_1024", "end_to_end")}
    assert e2e == {"scen_iters_per_s", "setup_s"}
    layer = {m["name"] for m in reg.metrics_of("quad_plan_1024", "per_layer")}
    assert layer and all(n.endswith(".plan") for n in layer)


def test_new_pieces_added_as_files_and_entries(tmp_path):
    """A new configuration, mix, cell and per-layer metric are files and
    entries: no file that is there is edited."""
    root = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    # a configuration: a copy of the piano under a new name, with its
    # reference beside it
    cfg = json.load(open(root / "configs" / "piano_mover.json"))
    cfg["name"] = "piano_short"
    (root / "configs" / "piano_short.json").write_text(json.dumps(cfg))
    shutil.copy(root / "configs" / "piano_mover_ref.py",
                root / "configs" / "piano_short_ref.py")
    (root / "mixes" / "plan_b8.json").write_text(json.dumps(
        {"kind": "plan", "scenarios": 8, "x0_sigma": 0.02, "judged": 2,
         "progress_iter": 5, "trace_iter": 5}))
    (root / "limits" / "piano_plan_8.json").write_text(json.dumps(
        {"limits": {"dyn_gap": 1e-5}}))
    (root / "metrics" / "window_steps.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['steps'])\n")
    bench["configs"].append({"name": "piano_short", "source": "x",
                             "file": "portbench/configs/piano_short.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "piano_plan_8", "config": "piano_short",
                               "traffic": "plan_b8", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "window_steps", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "solver", "moves": "scen_iters_per_s",
                               "workloads": ["piano_plan_8"]})
    bench["end_to_end"][0]["workloads"].append("piano_plan_8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = Registry(str(root))
    assert reg.config(reg.cell("piano_plan_8")["config"])["name"] == "piano_short"
    assert reg.reference("piano_short").dt == 0.1
    assert reg.mix("plan_b8")["scenarios"] == 8
    ctx = {"kind": "plan", "setup_s": 1.0, "trace": None,
           "window": {"work": 16.0, "elapsed": 2.0, "steps": 2}}
    got = reg.read_metrics("piano_plan_8", "per_layer", ctx)
    assert got == {"window_steps": {"value": 2.0, "unit": "steps"}}
    e2e = reg.read_metrics("piano_plan_8", "end_to_end", ctx)
    assert e2e["scen_iters_per_s"]["value"] == 8.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_missing_piece_raises():
    reg = Registry()
    with pytest.raises(KeyError):
        reg.cell("no_such_cell")
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric")
