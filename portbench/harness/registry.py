"""Find the benchmark's pieces by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


class Registry:
    """The pieces under one benchmark directory (``root``) and the
    ``BENCHMARK.json`` beside it."""

    def __init__(self, root: str = BENCH_DIR,
                 benchmark: Optional[str] = None):
        self.root = root
        path = benchmark or os.path.join(os.path.dirname(root),
                                         "BENCHMARK.json")
        with open(path) as f:
            self.bench = json.load(f)

    def _json(self, *parts) -> dict:
        path = os.path.join(self.root, *parts)
        if not os.path.exists(path):
            raise FileNotFoundError(f"benchmark file {path} not found")
        with open(path) as f:
            return json.load(f)

    def _module(self, path: str, name: str) -> ModuleType:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """A configuration by the file ``BENCHMARK.json`` names, or one that
        no cell runs yet by its name under ``configs/``."""
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(os.path.dirname(self.root),
                                       c["file"])) as f:
                    return json.load(f)
        path = os.path.join(self.root, "configs", f"{name}.json")
        if os.path.exists(path):
            return self._json("configs", f"{name}.json")
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def reference(self, config_name: str):
        """The plain reference beside a configuration's file."""
        mod = self._module(os.path.join(self.root, "configs",
                                        f"{config_name}_ref.py"),
                           f"portbench_ref_{config_name}")
        return mod.Reference(self.config(config_name))

    def mix(self, name: str) -> dict:
        return self._json("mixes", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return self._json("limits", f"{cell}.json")

    def reader(self, metric: str) -> ModuleType:
        """A metric's reader: ``metrics/<name>.py``, or for a split name
        such as ``x.plan`` the reader ``metrics/x.py`` of the quantity."""
        for stem in (metric, metric.split(".")[0]):
            path = os.path.join(self.root, "metrics", f"{stem}.py")
            if os.path.exists(path):
                return self._module(path, "portbench_metric_"
                                    + stem.replace(".", "_"))
        raise FileNotFoundError(f"no reader for metric {metric!r}")

    def metrics_of(self, cell: str, section: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
        that list it, and those without a ``workloads`` key whose
        end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.bench["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]}
        out = []
        for m in self.bench[section]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif section == "end_to_end" or m.get("moves") in e2e:
                out.append(m)
        return out

    def read_metrics(self, cell: str, section: str, ctx: Dict) -> Dict:
        """{name: {"value", "unit"}} of every metric a reader found."""
        out = {}
        for m in self.metrics_of(cell, section):
            v = self.reader(m["name"]).read(ctx)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
