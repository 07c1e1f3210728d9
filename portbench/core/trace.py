"""Spans and the reduction of ``torch.profiler`` traces.

The harness wraps each call into a layer of the program in ``span(name)``,
a ``record_function`` range whose name starts with ``pb.``. A profiled part
of a run is taken twice. The first pass records the device alone (kernels,
copies, fills): with no host-side recording it slows the host little, so
its device operations and its wall time (the host clock around the units,
which end in a synchronisation) give the busy and idle time. The second
pass records the host's ``pb.`` spans with the device's operations, on one
clock: it tells what the host was doing while the device idled, and its
host-side recording lengthens the host's share. ``TraceView`` holds both
and what the per-layer readers need besides (``info``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

PREFIX = "pb."
NAME_CHARS = 96
TOP = 10


def span(name: str):
    return torch.profiler.record_function(PREFIX + name)


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class TraceView:
    ops: list          # first pass: (name, start_us, end_us) on the device
    wall_us: float     # first pass: the host's wall time of the units
    spans: list        # second pass: (name, start_us, end_us) on the host
    span_ops: list     # second pass: the device's operations
    units: int         # steps or calls in each pass
    info: dict = field(default_factory=dict)

    def __post_init__(self):
        self.busy = _union([(s, e) for _, s, e in self.ops])

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy)

    @property
    def window_us(self) -> float:
        return self.wall_us

    def op_us(self, match) -> float:
        """Summed device time of the operations whose name satisfies
        ``match``."""
        return sum(e - s for n, s, e in self.ops if match(n))

    def op_count(self, match) -> int:
        return sum(1 for n, _, _ in self.ops if match(n))

    def idle_gaps(self) -> list:
        """(start, end) of each stretch of the second pass (its first span
        to its last span or device operation) in which the device
        idles."""
        busy = _union([(s, e) for _, s, e in self.span_ops])
        at = min([s for _, s, _ in self.spans] or [b[0] for b in busy])
        end = max([e for _, _, e in self.spans] + [b[1] for b in busy])
        gaps = []
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if end > at:
            gaps.append((at, end))
        return gaps

    def idle_by_span(self) -> dict:
        """Idle device time in µs by the ``pb.`` span the host was in
        meanwhile (the harness's spans do not nest); idle time outside
        every span is ``outside_spans``."""
        out: dict = {}
        for gs, ge in self.idle_gaps():
            covered = 0.0
            for n, s, e in self.spans:
                part = min(ge, e) - max(gs, s)
                if part > 0:
                    key = n[len(PREFIX):]
                    out[key] = out.get(key, 0.0) + part
                    covered += part
            if ge - gs > covered:
                out["outside_spans"] = (out.get("outside_spans", 0.0)
                                        + ge - gs - covered)
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, and the device's idle
        time by the span the host was in meanwhile, in seconds over the
        profiled part, at most ``TOP`` of each."""
        by_op: dict = {}
        for n, s, e in self.ops:
            key = n[:NAME_CHARS]
            by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e6
        by_span = {k: v / 1e6 for k, v in self.idle_by_span().items()}
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def profile(fn, units: int, info: dict) -> TraceView:
    """Runs ``fn()`` (which does ``units`` steps or calls and ends in a
    synchronisation) in a warm-up pass and once in each pass, and reduces
    the traces. A pass
    with no device activity (the profiler now and then drops a whole
    window) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity

    # the profiler's first recording in a process starts its tracer and
    # instruments each kernel's first launch: a pass that is thrown away
    _pass(fn, [ProfilerActivity.CUDA])
    ops, _, wall = _pass(fn, [ProfilerActivity.CUDA])
    span_ops, spans, _ = _pass(fn, [ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
    return TraceView(ops, wall, spans, span_ops, units, info)


def _pass(fn, activities):
    from torch.autograd import DeviceType
    from torch.profiler import profile as torch_profile

    for _ in range(3):
        with torch_profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            wall = (time.perf_counter() - t0) * 1e6
        ops, spans = [], []
        for e in prof.events():
            rng = (e.name, float(e.time_range.start),
                   float(e.time_range.end))
            if e.name.startswith(PREFIX):
                # a range also shows on the device's timeline as an
                # annotation; only the host's copy is a span
                if e.device_type != DeviceType.CUDA:
                    spans.append(rng)
            elif e.device_type == DeviceType.CUDA:
                ops.append(rng)
        if ops:
            return ops, spans, wall
    raise RuntimeError("the profiler recorded no device activity")
