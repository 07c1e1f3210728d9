"""The readers of the port's own spans and counters: None with nothing
recorded (or a port without a recorder), and the device-only pass's value
on a hand-built recorder of three passes (warm-up, device-only, host and
device), each pass's numbers apart."""

from __future__ import annotations

import importlib.util

import pytest

from conftest import ROOT

from db_text_minimal_tpu_torch.utils import profiling
from portbench.core import trace

TRAIN = ("prep_device_ms.train", "fwd_device_ms.train",
         "loss_device_ms.train", "bwd_device_ms.train",
         "optim_device_ms.train")
PHASES = ("train.preprocess", "train.forward", "train.loss",
          "train.backward", "train.optimizer")
SERVE = ("unclip_ms_per_box.serve", "upload_host_ms.serve")
UNITS = 2


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m", ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _view(kind: str, units: int = UNITS) -> trace.TraceView:
    return trace.TraceView([], 1.0, [], [], units, {"traffic": {
        "kind": kind}})


def _span(rec, name, parent=None, ms=1.0, at_ms=0.0, device_ms=None,
          counters=None):
    s = profiling.Span(name, next(rec._seq), parent)
    s.start_ns = int(at_ms * 1e6)
    s.end_ns = s.start_ns + int(ms * 1e6)
    s._device_ms = device_ms
    s.counters = counters
    rec.spans.append(s)
    return s


@pytest.fixture
def rec(monkeypatch):
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", r)
    return r


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_nothing_recorded_reads_none(rec, name):
    kind = "train" if name.endswith(".train") else "serve"
    assert _metric(name)(_view(kind)) is None


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_port_without_a_recorder_reads_none(monkeypatch, name):
    monkeypatch.delattr(profiling, "RECORDER")
    kind = "train" if name.endswith(".train") else "serve"
    assert _metric(name)(_view(kind)) is None


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_cell_of_the_other_kind_reads_none(rec, name):
    kind = "serve" if name.endswith(".train") else "train"
    assert _metric(name)(_view(kind)) is None


def _train_passes(rec):
    """Three passes of UNITS steps; the phase i of step j of pass k takes
    100·k + 10·j + i device ms, the step their sum."""
    for k in range(3):
        for j in range(UNITS):
            root = _span(rec, "train.step", device_ms=0.0)
            root.step = k * UNITS + j + 1
            for i, phase in enumerate(PHASES):
                _span(rec, phase, root, device_ms=100 * k + 10 * j + i)
            # a span outside every step is no phase of one
            _span(rec, PHASES[0], device_ms=1e6)


@pytest.mark.parametrize("i", range(len(TRAIN)))
def test_a_phase_reads_the_device_only_pass(rec, i):
    _train_passes(rec)
    # pass 1: the mean of 100 + i and 110 + i
    assert _metric(TRAIN[i])(_view("train")) == pytest.approx(105 + i)


def test_a_phase_with_two_spans_in_a_step_adds_them(rec):
    root = _span(rec, "train.step")
    for ms in (1.5, 2.0):
        _span(rec, "train.optimizer", root, device_ms=ms)
    assert _metric("optim_device_ms.train")(_view("train", 1)) == \
        pytest.approx(3.5)


def test_a_phase_without_device_events_reads_none(rec):
    root = _span(rec, "train.step")
    _span(rec, "train.forward", root)
    assert _metric("fwd_device_ms.train")(_view("train", 1)) is None


def _serve_passes(rec):
    """Three passes of UNITS calls. In pass k: an upload of 1 + k ms a call,
    an unclip of 2 + k ms host time, 1 ms of it in a child span, over
    10·(k + 1) records."""
    for k in range(3):
        for _ in range(UNITS):
            inf = _span(rec, "serve.inference", ms=50)
            _span(rec, "serve.upload", inf, ms=1 + k)
            _span(rec, "serve.forward", inf, ms=3)
            post = _span(rec, "serve.postprocess", ms=50)
            _span(rec, "serve.boxes_to_host", post, ms=7)
            unclip = _span(rec, "serve.unclip", post, ms=2 + k,
                           counters={"serve.rects_in": 10 * (k + 1),
                                     "serve.boxes_out": 9 * (k + 1)})
            _span(rec, "inner", unclip, ms=1)


def test_unclip_reads_self_time_over_records_of_the_device_only_pass(rec):
    _serve_passes(rec)
    # pass 1: self time 3 - 1 ms a call over 20 records a call
    assert _metric("unclip_ms_per_box.serve")(_view("serve")) == \
        pytest.approx(2.0 / 20)


def test_unclip_without_records_reads_none(rec):
    post = _span(rec, "serve.postprocess")
    _span(rec, "serve.unclip", post, counters={"serve.rects_in": 0})
    assert _metric("unclip_ms_per_box.serve")(_view("serve", 1)) is None


def test_upload_reads_host_time_a_call_of_the_device_only_pass(rec):
    _serve_passes(rec)
    assert _metric("upload_host_ms.serve")(_view("serve")) == \
        pytest.approx(2.0)


def test_fewer_roots_than_two_passes_read_them_all(rec):
    for ms in (1.0, 3.0):
        inf = _span(rec, "serve.inference", ms=10)
        _span(rec, "serve.upload", inf, ms=ms)
    assert _metric("upload_host_ms.serve")(_view("serve", 8)) == \
        pytest.approx(2.0)
