"""The FLOP and byte counters give hand-computed values."""

from __future__ import annotations

import importlib.util

import pytest
import torch

from conftest import ROOT

from portbench.core import trace
from portbench.reference import flops

R18 = {"backbone": "resnet18", "fpn_inner_channels": 256, "head_width": 64}
# resnet18 + FPN + DB head at 1 × 64², MACs by layer (worked by hand):
# stem 32²·64·3·49 = 9,633,792; layer1 4 · 16²·64·64·9 = 37,748,736;
# layer2, layer3, layer4 33,554,432 each (the strided conv1 4,718,592,
# conv2 9,437,184, the 1×1 shortcut 524,288, the second block 18,874,368);
# FPN 165,347,328 (reduces 1,048,576 + 524,288 + 262,144 + 131,072,
# smooths 589,824 + 2,359,296 + 9,437,184, the 3×3 conv 150,994,944);
# a head branch 42,205,184 (conv 37,748,736, deconvs 4,194,304 + 262,144).
BACKBONE = 9_633_792 + 37_748_736 + 3 * 33_554_432
FPN = 165_347_328
BRANCH = 42_205_184


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m", ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_resnet18_fpn_macs_at_64():
    assert flops.count(R18, 1, 64).macs == BACKBONE + FPN + 2 * BRANCH
    assert flops.forward_flops(R18, 1, 64, prob_only=True) == \
        2 * (BACKBONE + FPN + BRANCH)
    assert flops.train_step_flops(R18, 2, 64) == \
        3 * 2 * 2 * (BACKBONE + FPN + 2 * BRANCH)


def test_deformable_conv_counts_as_a_3x3_conv_and_its_offsets():
    ops = flops.CountOps()
    x = torch.empty((2, 8, 10, 10), device="meta")
    off = ops.conv(x, torch.empty((18, 8, 3, 3), device="meta"), None, 2, 1)
    ops.deform(x, off, torch.empty((16, 8, 3, 3), device="meta"), 2)
    # offsets 2·5²·18·8·9, the conv 2·5²·16·8·9
    assert ops.macs == 2 * 25 * 18 * 72 + 2 * 25 * 16 * 72
    assert ops.deform_shapes == [((2, 8, 10, 10), 2)]


def test_r50_dcn_has_thirteen_deformable_convs():
    cfg = {"backbone": "deformable_resnet50", "fpn_inner_channels": 256,
           "head_width": 64}
    shapes = flops.count(cfg, 16, 640, train=True).deform_shapes
    assert len(shapes) == 13
    assert shapes[0] == ((16, 128, 160, 160), 2)
    assert shapes[-1] == ((16, 512, 20, 20), 1)


def test_d1_bytes_of_one_conv():
    # x 1·4·8·8·4 = 1024, offsets 8·8·18·4 = 4608, bf16 columns
    # 9·8·8·4·2 = 4608: forward 10240, backward 4608 + 2·(1024 + 4608)
    assert _metric("d1_roofline.train").conv_bytes(1, 4, 8, 8, 1, 2) == \
        10240 + 15872


def test_k10_bound_at_the_training_batch():
    ops = [("k10_select", 0.0, 7.825)]
    view = trace.TraceView(ops, 10.0, [], ops, 1, {"traffic": {
        "kind": "train", "batch": 16, "image_size": 640}})
    # one read of 16·640²·4 bytes at 3.35 TB/s is 7.825 µs
    assert _metric("k10_roofline.train").read(view) == pytest.approx(
        100.0, rel=1e-3)


def test_union_of_device_intervals_and_idle_gaps():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0)]
    spans = [(trace.PREFIX + "step", 0.0, 18.0),
             (trace.PREFIX + "read", 18.0, 30.0)]
    view = trace.TraceView(ops, 30.0, spans, ops, 1, {})
    assert view.busy_us == 17.0 and view.window_us == 30.0
    assert view.idle_gaps() == [(12.0, 20.0), (25.0, 30.0)]
    gaps = dict(view.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"step": 6e-6, "read": 7e-6})
