"""The benchmark finds its configurations, traffic mixes, metrics and
limits by name, and takes up a new one from new files alone."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from conftest import ROOT

from portbench.core import trace
from portbench.core.registry import Registry


def test_every_named_file_loads():
    reg = Registry(ROOT)
    for w in reg.bench["workloads"]:
        cfg = reg.config(w["config"])
        assert cfg["name"] == w["config"]
        assert reg.traffic(w["traffic"])["kind"] in ("train", "serve")
        assert reg.limits(w["name"])
        for m in reg.metrics("per_layer", w["name"]):
            assert callable(reg.reader(m["name"]))
    for m in reg.bench["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


def test_each_cell_reports_what_its_metrics_move():
    reg = Registry(ROOT)
    for w in reg.bench["workloads"]:
        e2e = {m["name"] for m in reg.metrics("end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = reg.metrics("per_layer", w["name"])
        assert layer
        assert all(m["moves"] in e2e for m in layer)


def _fake_view(kind: str) -> trace.TraceView:
    """Two passes of one unit; the second pass's clock starts 1000 µs
    later than the first's, as each pass's trace has its own start."""
    ops = [("k10_select", 0.0, 10.0), ("gemm", 10.0, 30.0),
           ("k3_local", 40.0, 45.0), ("Memcpy DtoH", 45.0, 46.0)]
    later = 1000.0
    spans = [(trace.PREFIX + "train_step", later, later + 35.0),
             (trace.PREFIX + "postprocess_boxes", later + 35.0,
              later + 50.0)]
    span_ops = [(n, s + later, e + later) for n, s, e in ops]
    traffic = {"kind": kind, "batch": 2, "image_size": 64, "canvas": 64}
    return trace.TraceView(ops, 50.0, spans, span_ops, 1, {
        "traffic": traffic, "config": {}, "window_units": 1,
        "window_s": 1.0, "unit_flops": 1e12})


def test_a_new_cell_is_taken_up_from_new_files(tmp_path: Path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    per-layer metric, a cell and its limits, each a new file or a new
    entry; no file that was there changes, and the registry finds all."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    base = json.loads((ROOT / "portbench/configs/db_r18_fpn.json")
                      .read_text())
    base["name"] = "db_dummy"
    (tmp_path / "portbench/configs/db_dummy.json").write_text(
        json.dumps(base))
    traffic = json.loads((ROOT / "portbench/traffic/train_b16.json")
                         .read_text())
    traffic["batch"] = 4
    (tmp_path / "portbench/traffic/dummy_b4.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/metrics/dummy_share.train.py").write_text(
        "def read(view):\n    return 100.0 * view.busy_us / view.window_us\n")
    (tmp_path / "portbench/checks/dummy_train_b4.json").write_text(
        json.dumps({"loss_gap": 0.5}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "db_dummy", "source": "x",
                             "file": "portbench/configs/db_dummy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy_train_b4",
                               "config": "db_dummy", "traffic": "dummy_b4",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy_share.train", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "device",
                               "moves": "train_img_per_s",
                               "workloads": ["dummy_train_b4"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_per_s":
            m["workloads"].append("dummy_train_b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = {p: p.read_bytes() for p in before}
    assert after == before
    reg = Registry(tmp_path)
    assert reg.config("db_dummy")["name"] == "db_dummy"
    assert reg.traffic("dummy_b4")["batch"] == 4
    assert reg.limits("dummy_train_b4") == {"loss_gap": 0.5}
    names = [m["name"] for m in reg.metrics("per_layer", "dummy_train_b4")]
    assert names == ["dummy_share.train"]
    assert reg.reader("dummy_share.train")(_fake_view("train")) == \
        100.0 * 36.0 / 50.0


def test_readers_return_nothing_without_their_kernels():
    reg = Registry(ROOT)
    view = _fake_view("train")
    assert reg.reader("d1_roofline.train")(view) is None
    assert reg.reader("cc_device_ms.serve")(view) is None
    serve = _fake_view("serve")
    assert reg.reader("k10_roofline.train")(serve) is None
    assert reg.reader("cc_device_ms.serve")(serve) == 5e-3
    assert reg.reader("forward_busy_ms.serve")(serve) == 30e-3
    assert reg.reader("host_post_ms.serve")(serve) == 4e-3
