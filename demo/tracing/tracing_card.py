#!/usr/bin/env python3
"""The port's spans on the card, cell by cell of ``portbench/``.

    python demo/tracing/tracing_card.py --out chiprun_out/tracing \
        [--cells r18_train_b16,r18_serve_b32,r50dcn_train_b16] [--seed N]

For each cell, built as the benchmark builds it (its seeded weights and
traffic, ``portbench/core``), the script

1. times the cell's steps or calls under a device-only ``torch.profiler``
   pass with the port's recorder on, and again with it forced off, in turns
   (on, off, off, on, three times), and once with no profiler: the
   recorder's cost a unit; and the host cost of one span and one counter,
   on and off;
2. reads what the recorder kept in the last "on" pass: each span's mean
   host and device time a unit, the phases' device times against the
   step's, the counters a unit;
3. records a few units with ``utils/profiling.trace`` (the operator's
   Chrome trace) and sums each device operation's time under the program
   span that was open on the host when it was launched (the launch's
   correlation id ties the two).

It prints one JSON line a cell and writes ``<out>/<cell>.json``. Run it from
the root of a checkout on a machine with a CUDA card; ``--device cpu``
rehearses it on the CPU at a tiny size (no device operations, no events).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from db_text_minimal_tpu_torch.utils import profiling as P  # noqa: E402
from portbench.core import harness  # noqa: E402
from portbench.core import serve_cell as SC  # noqa: E402
from portbench.core import traffic as TG  # noqa: E402
from portbench.core import train_cell as TC  # noqa: E402
from portbench.core import weights as W  # noqa: E402
from portbench.core.registry import Registry  # noqa: E402

CELLS = ("r18_train_b16", "r18_serve_b32", "r50dcn_train_b16")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ORDER = (True, False, False, True) * 3
SPAN_CALLS = 20000
TOP = 15


def build(workload: str, seed: int, device: torch.device):
    """(kind, run(n) over n units ending in a synchronisation, units a
    timing)."""
    reg = Registry(ROOT)
    ctx = harness.make_context(reg, workload, seed, 1.0, False, time.time(),
                               device)
    traffic, cfg = ctx.traffic, ctx.config
    cuda = device.type == "cuda"
    if not cuda:   # a rehearsal: the portbench tests' tiny sizes
        if traffic["kind"] == "train":
            traffic.update(batch=2, image_size=64, log_iter=2)
        else:
            traffic.update(batch=2, canvas=320, long_side=480)
        ctx.workers = 1
    if traffic["kind"] == "train":
        host_pool = TG.make_pool(traffic, seed, ctx.workers)
        pool = TC.pin(host_pool) if cuda else [
            {k: torch.from_numpy(v) for k, v in b.items()}
            for b in host_pool]
        prog = TC.ProgramTrainer(cfg, traffic, W.make(cfg, seed, device),
                                 device)

        def run(n):
            TC.steps(prog, pool, 0, traffic["log_iter"], count=n)
        units = 20 if cuda else 2
    else:
        pool = TG.make_pool(traffic, seed, ctx.workers)
        server = SC.ProgramServer(
            cfg, traffic, SC.serve_weights(cfg, seed, pool[0], device),
            device)

        def run(n):
            SC.calls(server, pool, 0, count=n)
            if cuda:
                torch.cuda.synchronize()
        units = 16 if cuda else 2
    run(3)   # builds, warms up
    return traffic["kind"], run, units


def timed(run, n: int, activities, recorder_on: bool) -> float:
    """Seconds a unit of ``run(n)`` under a profiler of ``activities``
    (none: no profiler), the recorder forced off unless ``recorder_on``."""
    real = P._torch_profiler
    if not recorder_on:
        P._torch_profiler = types.SimpleNamespace(_is_profiler_enabled=False)
    try:
        if activities:
            with profile(activities=activities):
                t0 = time.perf_counter()
                run(n)
                dt = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            run(n)
            dt = time.perf_counter() - t0
    finally:
        P._torch_profiler = real
    return dt / n


def span_costs(device: torch.device) -> dict:
    """Host µs of one ``span`` entered and left (off; on, host only; on,
    with a device's two events) and of one ``count``, each the mean of
    ``SPAN_CALLS`` in a row; on under a device-only (CPU: host) profiler."""
    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else [
        ProfilerActivity.CPU]

    def per_call(fn):
        for _ in range(1000):
            fn()
        t0 = time.perf_counter()
        for _ in range(SPAN_CALLS):
            fn()
        return 1e6 * (time.perf_counter() - t0) / SPAN_CALLS

    def host_span():
        with P.span("x"):
            pass

    def device_span():
        with P.span("x", device=device):
            pass

    def counter():
        P.count("n", 1)

    out = {"span_off_us": per_call(host_span),
           "count_off_us": per_call(counter)}
    with profile(activities=activities):
        out["span_on_us"] = per_call(host_span)
        out["span_device_on_us"] = per_call(device_span)
        out["count_on_us"] = per_call(counter)
        if device.type == "cuda":
            torch.cuda.synchronize()
    P.RECORDER.clear()
    return out


def recorded(kind: str, units: int) -> dict:
    """Each span's mean host and device ms a unit over the last ``units``
    roots of the unit's root span, the counters a unit, and for training
    the phases' device sum against the step's."""
    spans = list(P.RECORDER.spans)
    # a call's first root is its serve.inference
    root_name = "train.step" if kind == "train" else "serve.inference"
    roots = [s for s in spans if s.parent is None]
    last = [s for s in roots if s.name == root_name][-units:]
    first = last[0].seq
    kept = [s for s in spans if s.root >= first]
    by_name: dict = {}
    for s in kept:
        e = by_name.setdefault(s.name, {"host_ms": 0.0, "device_ms": 0.0,
                                        "n": 0})
        e["host_ms"] += s.host_ms / units
        e["device_ms"] += (s.device_ms or 0.0) / units
        e["n"] += 1
        for k, v in (s.counters or {}).items():
            by_name[s.name].setdefault(k, 0.0)
            by_name[s.name][k] += v / units
    out = {"spans": by_name}
    if kind == "train" and last[0].device_ms is not None:
        gaps = []
        for r in last:
            phases = sum(s.device_ms for s in kept if s.parent == r.seq)
            gaps.append((r.device_ms - phases) / r.device_ms)
        out["phases_short_of_step"] = gaps
    return out


def attribute(path: str, units: int) -> dict:
    """Device ms a unit by the innermost program span open on the host at
    each device operation's launch, with each span's top operations."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches, ops, spans = {}, [], []
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append(e)
        elif cat == "program":
            spans.append(e)
        elif "correlation" in args and e.get("ph") == "X":
            launches[args["correlation"]] = e["ts"]
    spans.sort(key=lambda s: s["ts"])
    table: dict = {}
    for op in ops:
        at = launches.get((op.get("args") or {}).get("correlation"))
        where = "unlaunched" if at is None else "outside spans"
        if at is not None:
            inner = [s for s in spans if s["ts"] <= at <= s["ts"] + s["dur"]]
            if inner:
                where = max(inner, key=lambda s: s["ts"])["name"]
        t = table.setdefault(where, {"device_ms": 0.0, "ops": {}})
        ms = op["dur"] / 1e3 / units
        t["device_ms"] += ms
        name = op["name"][:100]
        t["ops"][name] = t["ops"].get(name, 0.0) + ms
    for t in table.values():
        t["ops"] = sorted(t["ops"].items(), key=lambda kv: -kv[1])[:TOP]
    return table


def cell(workload: str, seed: int, device: torch.device, out: Path) -> dict:
    kind, run, units = build(workload, seed, device)
    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else [
        ProfilerActivity.CPU]
    times = {"on": [], "off": []}
    for on in ORDER:
        P.RECORDER.clear()
        times["on" if on else "off"].append(
            1e3 * timed(run, units, activities, on))
        if on:
            spans = recorded(kind, units)
    times["no_profiler"] = [1e3 * timed(run, units, None, True)]
    res = {"cell": workload, "seed": seed, "units": units,
           "span_costs": span_costs(device), "unit_ms": times,
           "on_cost_ms": statistics.median(times["on"])
           - statistics.median(times["off"]), **spans}
    P.RECORDER.clear()
    with tempfile.TemporaryDirectory() as tmp:
        n = 3
        with P.trace(tmp):
            run(n)
        (path,) = Path(tmp).glob("trace_*.json")
        res["trace_mb"] = os.path.getsize(path) / 1e6
        res["by_span"] = attribute(str(path), n)
    if device.type == "cuda":
        res["card"] = harness.card()
        res["torch"] = torch.__version__
    (out / f"{workload}.json").write_text(json.dumps(res, indent=1))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--cells", default=",".join(CELLS))
    p.add_argument("--seed", type=int, default=2 ** 31 + 24)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    device = torch.device(args.device)
    for workload in args.cells.split(","):
        res = cell(workload, args.seed, device, out)
        short = {k: v for k, v in res.items() if k not in ("by_span",
                                                           "spans")}
        print(json.dumps(short), flush=True)
        TC.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
