"""A cell of BENCHMARK.json, found by name: its configuration (file of
sizes and the module that builds the program's model from it), its traffic
file, its reference model, its limits and the readers of its metrics."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Any, Dict, List, Mapping, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_file(path: str, prefix: str) -> ModuleType:
    """A module loaded from a file by path (its name may hold dots)."""
    name = prefix + re.sub(r"[^0-9A-Za-z_]", "_", os.path.basename(path)[:-3])
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: Mapping, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One workload of the benchmark, resolved by name. `config` and
    `traffic` may be given to stand in for the files (tests at small
    sizes)."""

    def __init__(self, workload: str, bench: Optional[Mapping] = None,
                 root: str = ROOT, config: Optional[Mapping] = None,
                 traffic: Optional[Mapping] = None,
                 limits: Optional[Mapping] = None):
        self.root = root
        self.bench_dir = os.path.join(root, "portbench")
        self.bench = bench if bench is not None else \
            read_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in self.bench["workloads"] if w["name"] == workload]
        if not found:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = workload
        self.chips = int(self.workload["chips"])
        conf_entry = [c for c in self.bench["configs"]
                      if c["name"] == self.workload["config"]][0]
        self.config = dict(config) if config is not None else \
            read_json(os.path.join(root, conf_entry["file"]))
        self.traffic = dict(traffic) if traffic is not None else read_json(
            os.path.join(self.bench_dir, "traffic", f"{self.workload['traffic']}.json"))
        self.config_module = load_file(os.path.join(
            self.bench_dir, "configs", f"{self.workload['config']}.py"),
            "portbench_config_")
        self.reference = importlib.import_module(
            f"portbench.reference.{self.config['model']}")
        limits_path = os.path.join(self.bench_dir, "limits", f"{workload}.json")
        self.limits = dict(limits) if limits is not None else (
            read_json(limits_path) if os.path.exists(limits_path) else {})
        self.end_to_end: List[Dict] = [m for m in self.bench["end_to_end"]
                                       if applies(m, workload)]
        self.per_layer: List[Dict] = [m for m in self.bench["per_layer"]
                                      if applies(m, workload)]

    def reader(self, metric: str) -> ModuleType:
        return load_file(os.path.join(self.bench_dir, "metrics", f"{metric}.py"),
                         "portbench_metric_")
