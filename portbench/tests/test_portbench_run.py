"""``run.py`` without a card, and in a directory without the port."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness.registry import BENCH_DIR, REPO

ARGS = ["--workload", "quad_plan_1024", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=300)


def test_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_fails_without_the_port(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = _run(str(tmp_path))
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")


def test_benchmark_json_keeps_the_contract_shape():
    b = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert "setup_s" in names and len(names) == len(set(names))
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in b["configs"]:
        assert c["file"].startswith("portbench/") and len(c["source"]) <= 200
