"""Shared fixtures of the benchmark's tests: a tiny CPU context for a cell
(small images and batches; the tests run here on the CPU) and a fixture
that skips a test marked ``cuda`` where there is no card."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_SEED = 2 ** 31 + 77


def tiny_context(workload: str, seconds: float = 1.0, seed: int = TINY_SEED):
    """A CPU context of ``workload`` with batches of 2, at 64² (training)
    or 320² (serving)."""
    from portbench.core import harness
    from portbench.core.registry import Registry

    reg = Registry(ROOT)
    ctx = harness.make_context(reg, workload, seed, seconds, False,
                               time.time(), "cpu")
    t = ctx.traffic
    if t["kind"] == "train":
        t.update(batch=2, image_size=64, log_iter=2, warmup_steps=1)
    else:
        t.update(batch=2, canvas=320, long_side=480, warmup_calls=1)
        # the least count of boxes compared is the cell's, at 32 canvases
        # of 640²: two of 320² hold a few
        ctx.limits["boxes"] = {"at_least": 1}
    ctx.workers = 1
    return reg, ctx


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
