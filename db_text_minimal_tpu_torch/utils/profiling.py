"""Profiling: a ``torch.profiler`` trace of a block, and per-step timing.

Counterpart of ``db_text_minimal_tpu/utils/profiling.py``: ``trace`` writes
a Chrome trace (viewable in Perfetto or ``chrome://tracing``) of the host
and, on a GPU, the card; ``StepTimer`` reports images per second."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``with trace("logs/profile"):`` records the block with
    ``torch.profiler`` (CPU activity, and CUDA activity when a GPU is
    present) and writes ``trace_<pid>.json`` into ``log_dir``; a no-op
    when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


class StepTimer:
    """Rolling throughput meter: ``tick(batch_size)`` per step, read
    ``images_per_sec``. The first ``warmup`` steps are not counted. On the
    card a step returns before the device finishes, so this is the rate at
    which steps are issued, which the device's rate bounds once its queue
    is full."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.steps = 0
        self.images = 0
        self.start = None

    def tick(self, batch_size: int) -> None:
        self.steps += 1
        if self.steps == self.warmup:
            self.start = time.perf_counter()
        elif self.steps > self.warmup:
            self.images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self.start is None or self.images == 0:
            return 0.0
        return self.images / (time.perf_counter() - self.start)
