"""Profiling: a ``torch.profiler`` trace of a block, and the program's own
spans and counters, recorded while ``torch.profiler`` records.

Counterpart of ``db_text_minimal_tpu/utils/profiling.py``: ``trace`` writes
a Chrome trace (viewable in Perfetto or ``chrome://tracing``) of the host
and, on a GPU, the card, with the program's spans as a track of their own.

The program marks its layers with ``span(name)`` and its outcomes with
``count(name, n)``. They record only while a ``torch.profiler`` profile is
active (``torch.autograd.profiler._is_profiler_enabled``, set on profiler
start and stop): otherwise ``span`` returns one shared no-op context
manager and ``count`` returns at once, after one global read. A recorded
span holds its name, its start and end on the host (``time.time_ns()``, the
clock the profiler's events are kept on, relative to the result's
``trace_start_ns()``), its parent, its root and the id of the step or call
it belongs to. A span given a CUDA device also records two timing events on
that device's current stream, and so its device time, read lazily
(``Span.device_ms``) once the caller has synchronised. A span is no
``record_function`` or NVTX range: the profiler's events stay as they are
without it. ``RECORDER`` keeps the last ``CAPACITY`` spans, the oldest
dropped first.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _torch_profiler

CAPACITY = 1 << 16
# the Chrome trace's process that holds the program's spans
TRACK_PID = 2 ** 31 - 1

_OFF = contextlib.nullcontext()


class Span:
    """One recorded span; ``counters`` holds what ``count`` added while it
    was the innermost open span (None when nothing was)."""

    __slots__ = ("name", "seq", "parent", "root", "step", "thread",
                 "start_ns", "end_ns", "counters", "_events", "_device_ms")

    def __init__(self, name: str, seq: int, parent: "Span | None",
                 step=None):
        self.name = name
        self.seq = seq
        if parent is None:
            self.parent, self.root, self.step = None, seq, step
        else:
            self.parent, self.root = parent.seq, parent.root
            self.step = parent.step if step is None else step
        self.thread = threading.get_native_id()
        self.start_ns = self.end_ns = 0
        self.counters = None
        self._events = None
        self._device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> float | None:
        """Milliseconds between the span's two events on the device, or
        None for a span without them. Read it after a synchronisation: the
        events are resolved (and released) at the first read."""
        if self._events is not None:
            start, end = self._events
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


class Recorder:
    """Spans and counters in memory, at most ``capacity`` spans."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.counters: dict = {}
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def mark(self) -> int:
        """A number below that of every span opened later."""
        return next(self._seq)

    @contextlib.contextmanager
    def span(self, name: str, step=None, device=None):
        stack = self._stack()
        s = Span(name, next(self._seq), stack[-1] if stack else None, step)
        events = None
        s.start_ns = time.time_ns()
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        stack.append(s)
        try:
            yield s
        finally:
            stack.pop()
            if events is not None:
                events[1].record(stream)
                s._events = events
            s.end_ns = time.time_ns()
            self.spans.append(s)

    def add(self, name: str, n: int) -> None:
        stack = self._stack()
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        if stack:
            top = stack[-1]
            if top.counters is None:
                top.counters = {}
            top.counters[name] = top.counters.get(name, 0) + n

    def clear(self) -> None:
        self.spans.clear()
        with self._lock:
            self.counters.clear()


RECORDER = Recorder()


def span(name: str, step=None, device=None):
    """``with span("train.forward", device=dev):`` records the block as a
    span of ``RECORDER`` while ``torch.profiler`` records, with its device
    time when ``device`` is a CUDA device. ``step`` is the id of the step or
    call a root span stands for; children take their root's."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return RECORDER.span(name, step, device)


def count(name: str, n: int) -> None:
    """Adds ``n`` (a host value: never one read from the device) to the
    counter ``name`` while ``torch.profiler`` records."""
    if _torch_profiler._is_profiler_enabled:
        RECORDER.add(name, int(n))


def chrome_events(spans, base_ns: int = 0) -> list:
    """The spans as Chrome trace events on one process of their own,
    ``ts`` in µs since ``base_ns`` (the trace's ``baseTimeNanoseconds``)."""
    out = [{"ph": "M", "name": "process_name", "pid": TRACK_PID,
            "args": {"name": "program spans"}},
           {"ph": "M", "name": "process_sort_index", "pid": TRACK_PID,
            "args": {"sort_index": -1}}]
    for s in spans:
        args = {"seq": s.seq, "parent": s.parent, "step": s.step}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        if s.counters:
            args.update(s.counters)
        out.append({"ph": "X", "cat": "program", "name": s.name,
                    "pid": TRACK_PID, "tid": s.thread,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``with trace("logs/profile"):`` records the block with
    ``torch.profiler`` (CPU activity, and CUDA activity when a GPU is
    present) and writes ``trace_<pid>.json`` into ``log_dir``, the
    program's spans of the block included (process "program spans"); a
    no-op when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = RECORDER.mark()
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    spans = [s for s in list(RECORDER.spans) if s.seq > first]
    if spans:
        with open(path) as f:
            data = json.load(f)
        data["traceEvents"] += chrome_events(
            spans, int(data.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(data, f)
