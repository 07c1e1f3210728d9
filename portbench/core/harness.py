"""One run of one cell: the pieces that every traffic kind shares.

``run_cell`` finds the cell's configuration, traffic and limits, runs the
traffic kind's runner (``<kind>_cell.run``), reads the per-layer metrics
of a traced run, decides ``correct`` and builds the result line.
"""

from __future__ import annotations

import importlib
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from ..reference import flops
from . import compare
from .traffic import WORKERS
from .registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "db_text_minimal_tpu")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def card() -> dict:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return {}
    name, limit = (s.strip() for s in line.split(",", 1))
    return {"name": name, "power_limit": limit}


@dataclass
class RunContext:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: torch.device
    workers: int = WORKERS
    program_factory: object = None
    phases: dict = field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Records the seconds since the process started at the end of a
        set-up phase."""
        self.phases[phase] = time.time() - self.t_start

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return max(torch.cuda.max_memory_allocated(i)
                   for i in range(self.workload["chips"]))

    def trace_info(self, units: int, window_s: float) -> dict:
        """What the per-layer readers need besides the trace: the cell's
        configuration and traffic, the untraced window's units and
        seconds, and the model FLOPs of a unit."""
        t, cfg = self.traffic, self.config
        if t["kind"] == "train":
            unit_flops = flops.train_step_flops(cfg, t["batch"],
                                                t["image_size"])
        else:
            unit_flops = flops.forward_flops(cfg, t["batch"], t["canvas"],
                                             prob_only=True)
        return {"config": cfg, "traffic": t, "window_units": units,
                "window_s": window_s, "unit_flops": unit_flops}


def runner(kind: str):
    return importlib.import_module(f"portbench.core.{kind}_cell")


def default_factory(kind: str):
    mod = runner(kind)
    return mod.ProgramTrainer if kind == "train" else mod.ProgramServer


def make_context(reg: Registry, workload: str, seed: int, seconds: float,
                 trace: bool, t_start: float, device) -> RunContext:
    wl = reg.workload(workload)
    traffic = reg.traffic(wl["traffic"])
    return RunContext(workload=wl, config=reg.config(wl["config"]),
                      traffic=traffic, limits=reg.limits(workload),
                      seed=seed, seconds=seconds, trace=trace,
                      t_start=t_start, device=torch.device(device),
                      program_factory=default_factory(traffic["kind"]))


def run_cell(reg: Registry, ctx: RunContext) -> tuple[dict, list[str]]:
    """(the result line's object, the lines naming each number compared
    beside its limit)."""
    out = runner(ctx.traffic["kind"]).run(ctx)
    name = ctx.workload["name"]
    if ctx.trace:
        view = out["view"]
        metrics = {}
        for m in reg.metrics("per_layer", name):
            value = reg.reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out["end_to_end"][m["name"]]),
                               "unit": m["unit"]}
                   for m in reg.metrics("end_to_end", name)}
    numbers = out["numbers"]
    correct = (compare.check(numbers, ctx.limits) and out["failed"] == 0
               and all(math.isfinite(v["value"]) for v in metrics.values()))
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": ctx.workload["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace:
        device["busy_s"] = view.busy_us / 1e6
        device["window_s"] = view.window_us / 1e6
        result["breakdown"] = view.breakdown()
    result["window"] = out["window"]
    result["details"] = {**out["details"], "setup_phases": ctx.phases,
                         "readings": {
        k: v for k, v in numbers.items() if k not in ctx.limits}}
    if ctx.device.type == "cuda":
        result["card"] = card()
    result["checks"] = {
        k: {"value": numbers[k], **(v if isinstance(v, dict)
                                    else {"limit": v})}
        for k, v in ctx.limits.items()}
    lines = [f"check {k} {numbers[k]!r} {compare.describe(v)}"
             for k, v in ctx.limits.items()]
    return result, lines
