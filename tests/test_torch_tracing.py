"""The port's spans and counters (``utils/profiling``): recorded only while
``torch.profiler`` records, nested with their parents and ids, on the
profiler's clock, never among the profiler's events; the train step's five
phases, the serving postprocess's spans and counters, and the program's
spans in ``trace``'s Chrome trace. The tests marked ``cuda`` hold the
recorder to the card: the same device operations with it on and off, and
the phases' device times summing to the step's.

This file imports no JAX, so the card's tests run on the GPU machine,
which has none, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import collections
import json
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from db_text_minimal_tpu_torch.config import default_config
from db_text_minimal_tpu_torch.data.scenes import text_batch
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.serve.handler import DBTextDetectionHandler
from db_text_minimal_tpu_torch.train import trainer as T
from db_text_minimal_tpu_torch.utils import profiling as P
from torch_scenes import rot_rect

PHASES = ("train.preprocess", "train.forward", "train.loss",
          "train.backward", "train.optimizer")
CPU_ONLY = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def recorder():
    P.RECORDER.clear()
    yield P.RECORDER
    P.RECORDER.clear()


def _names(rec):
    return [s.name for s in rec.spans]


def _children(rec, parent):
    return [s for s in rec.spans if s.parent == parent.seq]


# ------------------------------------------------------------ the recorder --

@pytest.mark.parametrize("call", [
    lambda: P.span("a"), lambda: P.span("a", 3),
    lambda: P.span("a", device=torch.device("cpu")),
    lambda: P.count("n", 2)])
def test_off_records_nothing(recorder, call):
    """Without a profiler a span is the one shared no-op, and nothing is
    recorded; a counter adds nothing."""
    out = call()
    if out is not None:
        assert out is P._OFF
        with out:
            torch.ones(3).sum()
    assert not recorder.spans and not recorder.counters


def test_spans_nest_with_parents_ids_self_times_and_counters(recorder):
    with profile(activities=CPU_ONLY):
        for step in (1, 2):
            with P.span("root", step):
                P.count("n", 1)
                with P.span("child"):
                    with P.span("leaf"):
                        P.count("n", 2)
                        P.count("m", 5)
                with P.span("child"):
                    pass
    assert _names(recorder) == ["leaf", "child", "child", "root"] * 2
    roots = [s for s in recorder.spans if s.name == "root"]
    assert [r.step for r in roots] == [1, 2]
    for root in roots:
        assert root.parent is None and root.root == root.seq
        kids = _children(recorder, root)
        assert [k.name for k in kids] == ["child", "child"]
        (leaf,) = _children(recorder, kids[0])
        assert {s.step for s in (leaf, *kids)} == {root.step}
        assert {s.root for s in (leaf, *kids)} == {root.seq}
        assert root.start_ns <= kids[0].start_ns <= leaf.start_ns
        assert leaf.end_ns <= kids[0].end_ns <= kids[1].start_ns
        assert kids[1].end_ns <= root.end_ns
        self_ns = (root.end_ns - root.start_ns) - sum(
            k.end_ns - k.start_ns for k in kids)
        assert 0 <= self_ns <= root.end_ns - root.start_ns
        assert root.counters == {"n": 1}
        assert leaf.counters == {"n": 2, "m": 5}
        assert kids[0].counters is None and leaf.device_ms is None
    assert recorder.counters == {"n": 6, "m": 10}


def test_span_shares_the_profilers_clock():
    """A span's host stamps, and the profiler's events moved by its
    ``trace_start_ns()``, are one clock: the span encloses the ATen
    operators run inside it."""
    with profile(activities=CPU_ONLY) as prof:
        with P.span("outer"):
            x = torch.randn(64, 64)
            (x @ x).relu().sum()
    start = prof.profiler.kineto_results.trace_start_ns()
    (outer,) = P.RECORDER.spans
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    assert {"aten::mm", "aten::relu", "aten::sum"} <= {e.name for e in ops}
    for e in ops:
        # the profiler keeps µs as floats: 1 µs of rounding
        assert outer.start_ns - 1e3 <= start + e.time_range.start * 1e3
        assert start + e.time_range.end * 1e3 <= outer.end_ns + 1e3


def test_no_program_span_among_the_profilers_events():
    with profile(activities=CPU_ONLY) as prof:
        with P.span("program.outer", 1):
            with P.span("program.inner"):
                torch.ones(8).cumsum(0)
    names = {e.name for e in prof.events()}
    assert "aten::cumsum" in names
    assert not any(n.startswith("program.") for n in names)
    assert len(P.RECORDER.spans) == 2


def test_the_recorder_keeps_the_newest_spans_up_to_its_capacity():
    rec = P.Recorder(capacity=4)
    for i in range(10):
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans] == ["s6", "s7", "s8", "s9"]


# ------------------------------------------------ the program's boundaries --

SIZE, BATCH = 64, 2


def _cfg(tmp_path):
    cfg = default_config()
    cfg.meta.device = "cpu"
    cfg.meta.root_dir = str(tmp_path)
    cfg.hps.img_size = SIZE
    cfg.hps.batch_size = BATCH
    cfg.hps.log_iter = 1
    cfg.logging.logger_file = None
    return cfg


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))


def test_a_train_epoch_records_each_step_and_its_five_phases(tmp_path,
                                                            recorder):
    """Under the profiler each step is ``train.step`` (id = its number)
    over the five phases in order; the epoch's rate is its images over its
    synchronised wall time."""
    trainer = T.Trainer(_cfg(tmp_path), [text_batch(5 + i, BATCH, SIZE)
                                         for i in range(2)],
                        tb_writer=_Writer())
    state = trainer.init_state()
    with profile(activities=CPU_ONLY):
        state, _, _, _ = trainer.train_epoch(state, 0)
    roots = [s for s in recorder.spans if s.name == "train.step"]
    assert [r.step for r in roots] == [1, 2] and state.step == 2
    for root in roots:
        kids = _children(recorder, root)
        assert tuple(k.name for k in kids) == PHASES
        assert all(k.step == root.step for k in kids)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
        assert root.start_ns <= kids[0].start_ns
        assert kids[-1].end_ns <= root.end_ns
        assert root.device_ms is None   # no events on the CPU
    rates = [v for t, v, _ in trainer.tb_writer.scalars
             if t == "TRAIN/HPs/images_per_sec"]
    assert rates == [2 * BATCH / trainer.epoch_timing["wall_s"]]


def test_postprocess_boxes_records_its_stages_and_counts(recorder):
    """``postprocess_boxes`` on maps of three rects each: the postprocess's
    root over its four stages, and the counters equal to the records the
    host finished and the boxes it returned."""
    prob, _, _ = rot_rect()
    maps = torch.from_numpy(np.stack([prob, prob[::-1].copy()]))[..., None]
    handler = DBTextDetectionHandler(forward=lambda b: maps, device="cpu")
    with profile(activities=CPU_ONLY):
        handler.inference(np.zeros((2, 8, 8, 3), np.uint8))
        out = handler.postprocess_boxes(maps)
    roots = [s for s in recorder.spans if s.parent is None]
    assert [(r.name, r.step) for r in roots] == [
        ("serve.inference", 1), ("serve.postprocess", 1)]
    kids = _children(recorder, roots[1])
    assert [k.name for k in kids] == ["serve.device_boxes",
                                      "serve.boxes_to_host", "serve.unclip",
                                      "serve.to_lists"]
    boxes = sum(len(r["boxes"]) for r in out)
    assert boxes == 6
    assert kids[2].counters == {"serve.rects_in": 6,
                                "serve.boxes_out": boxes}
    assert recorder.counters == kids[2].counters


def test_trace_writes_the_program_spans_into_its_chrome_trace(tmp_path,
                                                              recorder):
    with P.span("before"):   # no profiler yet: not recorded
        pass
    with P.trace(str(tmp_path)):
        with P.span("outer", 4):
            with P.span("inner"):
                torch.ones(4).cumsum(0)
    (path,) = tmp_path.glob("trace_*.json")
    data = json.loads(path.read_text())
    events = data["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program"}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["pid"] == inner["pid"] == P.TRACK_PID
    assert outer["args"]["step"] == inner["args"]["step"] == 4
    assert inner["args"]["parent"] == outer["args"]["seq"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # on the trace's own timeline: around the operator run inside
    (op,) = [e for e in events if e.get("name") == "aten::cumsum"]
    assert inner["ts"] - 1 <= op["ts"]
    assert op["ts"] + op["dur"] <= inner["ts"] + inner["dur"] + 1
    assert any(e.get("ph") == "M" and e.get("pid") == P.TRACK_PID
               and e["args"].get("name") == "program spans" for e in events)


# ------------------------------------------------------------- the card ----

def _r18_steps(device, n_steps, batch=4, size=640):
    """A bf16 DB-ResNet-18 training state on ``device``, its step and
    ``n_steps`` batches uploaded as the ``Trainer`` uploads them."""
    cfg = default_config()
    cfg.meta.device = str(device)
    cfg.hps.batch_size, cfg.hps.img_size = batch, size
    cfg.optimizer.reduction = "none"
    model = DBTextModel(compute_dtype=T.compute_dtype(cfg, device))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    state = T.TrainState(model, T.make_optimizer(cfg, model))
    step = T.build_train_step(cfg)
    batches = [T.to_device(text_batch(30 + i, batch, size), device)
               for i in range(n_steps)]
    return state, step, batches


def _device_ops(prof):
    return collections.Counter(e.name for e in prof.events()
                               if e.device_type == DeviceType.CUDA)


@pytest.mark.cuda
def test_the_recorder_leaves_the_device_operations_unchanged(monkeypatch,
                                                             recorder):
    """A device-only profiler pass of 3 steps shows the same device
    operations, by name and count, with the recorder on and forced off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    device = torch.device("cuda")
    state, step, batches = _r18_steps(device, 3)
    state, *_ = step(state, batches[0], 1e-4)   # builds and warms up
    torch.cuda.synchronize()
    seen = []
    for mode in ("on", "off", "on"):
        if mode == "off":
            monkeypatch.setattr(P, "_torch_profiler", types.SimpleNamespace(
                _is_profiler_enabled=False))
        else:
            monkeypatch.undo()
        recorder.clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for b in batches:
                state, *_ = step(state, b, 1e-4)
            torch.cuda.synchronize()
        assert len(recorder.spans) == (18 if mode == "on" else 0)
        seen.append(_device_ops(prof))
    assert seen[0] and seen[0] == seen[1] == seen[2]


@pytest.mark.cuda
def test_the_phases_device_times_sum_to_the_steps(recorder):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    device = torch.device("cuda")
    state, step, batches = _r18_steps(device, 3)
    state, *_ = step(state, batches[0], 1e-4)
    with profile(activities=[ProfilerActivity.CUDA]):
        for b in batches:
            state, *_ = step(state, b, 1e-4)
        torch.cuda.synchronize()
    roots = [s for s in recorder.spans if s.name == "train.step"]
    assert len(roots) == 3
    for root in roots:
        kids = _children(recorder, root)
        assert tuple(k.name for k in kids) == PHASES
        total = sum(k.device_ms for k in kids)
        assert root.device_ms > 0
        assert abs(total - root.device_ms) <= 0.05 * root.device_ms, (
            [(k.name, k.device_ms) for k in kids], root.device_ms)
