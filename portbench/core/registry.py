"""Finds a cell's files by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` of its ``configs`` entry;
- a traffic mix: ``portbench/traffic/<traffic>.json``;
- a per-layer metric: ``portbench/metrics/<name>.py``, a module with
  ``read(view) -> float | None`` (``view`` a ``trace.TraceView``);
- a cell's correctness limits: ``portbench/checks/<workload>.json``.

A later change adds a configuration, a traffic mix, a metric or a cell by
adding such files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Registry:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "portbench"
        self.bench = load_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.bench_dir / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return load_json(self.bench_dir / "checks" / f"{workload}.json")

    def metrics(self, section: str, workload: str) -> list[dict]:
        """The entries of ``section`` (``end_to_end`` or ``per_layer``) the
        cell reports: those that list it under ``workloads``; those with
        no such key, an end-to-end metric in every cell, a per-layer one
        in every cell that reports the metric it ``moves``."""
        entries = self.bench[section]
        if section == "end_to_end":
            return [m for m in entries
                    if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in self.metrics("end_to_end", workload)}
        return [m for m in entries
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str):
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
