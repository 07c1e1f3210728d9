#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU::

    python3 chip_smoke.py

Phases, one output line each (or more), stopping at the first failure:

1. build   - compile the CUDA kernels (csrc/cc.cu, csrc/int8_epilogue.cu,
             csrc/int8_conv.cu and csrc/deform.cu, nvcc sm_90a), the host
             geometry library and the Triton kernels K1 and K2
             (ops/db_step_triton.py), in parallel.
2. kernels - hold P1 (csrc/int8_epilogue.cu) bit for bit against its plain
             version in both forms (f32 at the FPN output conv's 8x160x160
             x256, int8 at a layer-2 conv1's 8x80x80x128); the int8 conv
             (csrc/int8_conv.cu: implicit GEMM on the tensor cores with P1's
             epilogue in registers) bit for bit against its plain version
             (im2col, torch._int_mm, P1's plain version) at each of the int8
             forward's 11 distinct conv shapes at batch 8 in each form the
             forward uses, each timed cold beside the route it replaces
             (im2col, torch._int_mm, P1's kernel) and its bound (int8
             operations at 1,979 TOP/s against the bytes); and each kernel
             K3-K7 against its plain PyTorch version on the
             card at the serving path's shapes (8 prob maps of 640x640,
             K = 1000 slots; K7's stats in its bbox_stats and poly_stats
             forms, K7's bit-pack also at width 100), K8
             (fast_boxes) against its run on the CPU, and K1, K2 forward
             and K2 backward at the training shapes (P and T of
             4x1x640x640, the backward's gradient at the element stride of
             the NHWC output's last channel); time each and its plain
             version, and the rect and polygon drivers (K9 device_boxes,
             K7 device_poly_stats) on the card and on the CPU. Then K3 bit
             for bit against its plain version on its hard masks (full,
             empty, checkerboard, diagonals through every tile corner,
             serpentines, noise at densities 0.41, 0.5, 0.59), 8- and
             4-connected, at 8x640x640 and a ragged 8x637x641, and K5
             against its plain version along the rect path (K3, K4, K6
             by their kernels) on the same masks and on maps of rotated
             bars (0, 90, +-45 degrees, small angles near 0), at both
             sizes. Every row logs the card's time split by launch.
2b. d1     - D1 (csrc/deform.cu), the deformable conv's sampling: its
             forward (deform_im2col) and backward (deform_col2im) held to
             their plain halves on the card at each of deformable_resnet50's
             six deformable conv shapes at batch 8, 640x640 (80x80 C=128
             at stride 1 and from 160x160 at stride 2; 40x40 C=256 and
             20x20 C=512, each also from stride 2), bf16 and fp32 columns,
             zero and random offsets (std 3 and 12 px, taps outside the
             map), the column gradient laid out as deform_conv's backward
             hands it over: fp32 columns bit-equal, bf16 within one bf16
             ulp, dx within 1e-5 and doffsets within 1e-4 of their
             largest. Each case timed cold against its bound, by events
             and by the profiler's device time; the rows at 8x80x80x128,
             bf16, std 3 px, with the whole conv's bound and
             one F.grid_sample over the 9-tap grid (its backward for the
             backward row) as library_ms.
3. serve   - serve one batch of 8 synthetic 640x480 images through the
             port's handler in box mode, infer_mode "flax": resnet18 + FPN
             (inner 256) + FusedDBHead, bf16 (the default on the card),
             weights drawn from a seed and loaded from a .pth with the
             reference's key names. Every kernel of the rect path (K3-K6)
             must launch. Then the same mode in fp32 (the parity
             configuration): its maps within a mean of 0.02 of bf16's,
             and both timed in turns. Then time K3
             on the served maps' masks (both connectivities), K4 on their
             labels, K6, K5 and K7's stats (poly_stats form) on their slot
             maps, each held to its plain version.
4. quant   - the BN-folded and int8 serving path on the same .pth and
             batch: the handler in "folded" mode (its default; no int8
             kernel may launch) and in "int8" mode (dynamic scales, 17 int8
             convs: the int8 conv's kernel launches 17 times a forward, P1's
             never), and make_folded_forward with static scales calibrated
             on the batch (7 int8-form and 10 f32-form launches), each in
             box mode (K3-K6 must launch); the same stage timing as the
             serve phase for each, and each forward profiled (top kernels;
             the int8 forwards call no torch._int_mm and no unfold, and
             launch no P1 kernel). Then the quant checks (see check).
5. export  - serve/export on the same .pth at 640x640: the flax (bf16),
             folded and int8 archives (.pt2; symbolic batch, uint8 input,
             the folded and int8 ones prob-only), each loaded back, batch 1
             and 8 from one archive held to the live forward of its mode
             (at most 1 % of pixels more than 1e-3 apart) and timed
             against it; the int8 archive launches the int8 conv's kernel
             17 times a forward through the custom op dbtext::int8_conv. The
             folded and
             int8 archives then serve the batch through the handler in
             box mode (K3-K6 launch; the folded archive's boxes within
             2.5 px of the live folded handler's) and refuse masks mode.
6. prune   - cli.prune on the .pth at the JAX p50 keeps (.5/.75/.5; the
             JAX report's widths and param ratio .5048) and at odd keeps
             (.3, 1, 130: int8 convs with K and N padded to multiples of
             8, channels no multiples of 16); each loaded with its sidecar
             by load_model and
             build_inference_forward, folded fp32 held to the model fp32
             (the full model's gaps beside), served folded and int8 in box
             mode (K3-K6, the int8 conv's kernel once per int8 conv); 3
             bf16 train steps of the
             p50 model at batch 4 (K2 each step; checkpoints with the
             sidecar); the odd-keep int8 archive held as in export; the
             folded forward and handle() at batch 8, full against p50.
7. polygon - the served batch's maps through DevicePolyRepresenter
             (polygon mode, the reference's default output): every kernel
             of its device half (K3 both ways, K4 twice, K6, K7's bbox
             statistics and bit-pack) must launch. Then the device part,
             the copy to the host and the host finishing are timed on the
             served batch and on the 8 kernel scenes.
8. train   - the training configuration of the JAX package's defaults:
             resnet18 + FPN (inner 256) + DBHead in train mode, 640², batch
             4, bf16 compute with f32 parameters and loss, true per-pixel
             OHEM, Adam at lr 0.005. Twelve steps of Trainer.train_epoch on
             one synthetic batch (numpy scenes, GT maps in the compact
             layout); K2 forward and backward must launch once a step and
             the loss must fall. The same in fp32 with TF32 off (the parity
             configuration), and both at batch 16; each run timed and
             profiled (busy share, top kernels). Then
             Trainer.eval_epoch in rect mode on two test images (K3-K6 must
             launch), eval_epoch under the default configuration (polygon
             mode, on the host as in the JAX trainer) and the quality
             bench's full_eval with its four rows (host and device, rect and
             polygon; K3-K7 must launch); P, R, F lie in [0, 1].
8b. families - every other detector family the JAX package builds, at
             full width, 640x640, weights from a seed (offset branches
             drawn from N(0, 0.01), BN statistics calibrated to the served
             batch on the card): resnet34, resnet50, deformable_resnet18,
             deformable_resnet50, resnet101 and resnet152 with FPN +
             DBHead, and resnet18 with FPEM_FFM + DBHead, each saved as a
             .pth, loaded by load_model (bf16 and fp32) and served in box
             mode through DBTextDetectionHandler(forward=...) (K3-K6 must
             launch), bf16 maps within a mean 0.02 of fp32's, the forward
             at batch 8 timed in both by CUDA events; deformable_resnet50
             and resnet18 + FPEM_FFM one fp32 forward on the card against
             the CPU (TF32 off, max abs 1e-4), three bf16 train steps at
             batch 4 (K2 each step, finite losses, the offsets move under
             dcn_offset_lr_mult 0.1) and a step at batch 16 timed;
             DeformConv's share of deformable_resnet50's forward (batch 8)
             and train step (batch 16) by torch.profiler under
             record_function ranges, and D1's kernels' time by name. D1
             launches 6 times in a served deformable_resnet18 forward, 13
             in deformable_resnet50's and 13 + 13 in its train step; the
             two deformable families' forwards (bf16, fp32) and bf16 step
             at batch 16 are timed in turns with D1's kernels and with
             the plain DeformConv (plain_deform_forward, PR 14's module
             swapped into the module instances). deformable_resnet18's
             fp32 model is exported on the card (flax mode, symbolic
             batch, uint8 input), loaded back and held to its live
             forward, D1 launching 6 times in a forward of the archive.
9. check   - device boxes against the host rect-mode SegDetectorRepresenter
             on synthetic scenes, device polygons against the host polygon
             mode on the kernel scenes, K7 on the card against K7 on the
             CPU, the model on the card against the same model on the CPU
             and one train step on the card against the same step on the
             CPU (both in the fp32 parity configuration),
             the folded and int8 prob maps against the flax mode's, the
             calibrated int8 forward on the card against the CPU (float
             convs in f64 and in f32) and its fused and unfused forms
             against each other.
10. quality - the quality bench end to end at 640x640, batch 16: a small
             hard set from the port's generator (32 train and 16 test
             images, seed 7) with the committed trace of cv2 5.0.0's text
             engine replayed (each image's GT held to the trace's hash),
             quality_bench.main for one epoch, in bf16, with
             --reduction none --polygon --save_checkpoint (K2 in every
             step; K3-K7 in the eval's four rows), then --eval_only
             --quant on the checkpoint (the int8 conv's kernel, K3-K6 in the
             device row); both reports must have the JAX report's keys and
             finite P/R/F. Logs the generation, train and eval times, each
             row's postprocess time, the loader's share of the epoch and
             the host ms of a training sample.
11. ocr    - the recognizer and the OCR path at full width (output channel
             512, hidden 256, 32x100 crops, batch_max_length 25): word
             crops exported from the quality set's train split; three
             recognizers with seeded weights (None/VGG/BiLSTM/CTC, the
             base; None/ResNet/BiLSTM/Attn, cli.ocr's default;
             TPS/RCNN/BiLSTM/CTC) held card against CPU on a batch of 64
             crops (logits within REC_TOL, greedy strings equal where
             every top-2 margin exceeds it), each forward timed; 12 train
             steps at batch 32 of the base and of the Attn recognizer
             (finite losses, the last 10 steps timed); then cli.train_rec
             for 2 epochs (base), rec_bench --mode rec and --mode e2e on
             the quality set with its quality.ckpt detector (reports with
             JAX's keys, total > 0), and cli.ocr.main on a test image with
             --infer_mode int8 (the int8 conv must launch), its detect and
             crop stages
             timed, and its recognize stage on the image's GT crops.
12. tools  - the JAX package's Flax checkpoint reader on the card: the
             committed fixture (tests/make_flax_fixture.py, a narrow
             detector and its JAX maps) in fp32, max abs 1e-4 from the JAX
             maps; cli/test at full width on the serve phase's .pth in the
             heatmap, polygon and rect modes, flax and int8 (the int8 conv
             17 times a run), card against CPU; cli/webcam with recognition on a
             6-frame mp4v video of the 640x480 images, frames/s;
             pretrain_backbone_dense at full resnet18 width (8 steps of 64
             crops), its .pth loaded by a Trainer, ms a step; cli.train
             with --coordinator_address (NCCL, a group of one, the model in
             DistributedDataParallel) and --profile_dir on the quality set
             (K2 in each of 16 steps, its kernels named in the trace), then
             a bf16 step at batch 4 plain and in DDP; quality_bench
             --eval_only --dump_eval_dir on quality.ckpt.

Every kernel time is taken with the 50 MB L2 flushed before each call
(``flush_l2``), as a caller that did other work in between finds it; the
flush's own kernel is left out of the device sums. Then a
``{"kernels": [...]}`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no GPU is available or any phase fails.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from db_text_minimal_tpu_torch.cli import prune as prune_cli
from db_text_minimal_tpu_torch.cli import quality_bench
from db_text_minimal_tpu_torch.cli.common import (build_inference_forward,
                                                  load_model,
                                                  load_state_dict,
                                                  make_folded_forward)
from db_text_minimal_tpu_torch.config import default_config
from db_text_minimal_tpu_torch.data.scenes import text_batch
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.models import quant_infer as Q
from db_text_minimal_tpu_torch.ops import cc, geometry
from db_text_minimal_tpu_torch.ops import db_step as D
from db_text_minimal_tpu_torch.ops import deform as DF
from db_text_minimal_tpu_torch.ops import int8 as I8
from db_text_minimal_tpu_torch.postprocess import (DeviceBoxRepresenter,
                                                   DevicePolyRepresenter,
                                                   SegDetectorRepresenter)
from db_text_minimal_tpu_torch.models.prune import load_widths
from db_text_minimal_tpu_torch.serve.export import export_model, load_exported
from db_text_minimal_tpu_torch.serve.handler import DBTextDetectionHandler
from db_text_minimal_tpu_torch.train import trainer as T
from db_text_minimal_tpu_torch.utils import CAFFE_MEAN

SEED = 0
N, SIZE, K = 8, 640, 1000
HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate
FP32_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit rate
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate
INT8_OPS_PER_S = 1979e12        # H100 SXM dense int8 tensor-core rate
SRC = "db_text_minimal_tpu_torch/csrc/cc.cu"
JAX_CC = "db_text_minimal_tpu/ops/pallas/cc.py"
TRITON_SRC = "db_text_minimal_tpu_torch/ops/db_step_triton.py"
JAX_DB_STEP = "db_text_minimal_tpu/ops/pallas/db_step.py"
INT8_SRC = "db_text_minimal_tpu_torch/csrc/int8_epilogue.cu"
DEFORM_SRC = "db_text_minimal_tpu_torch/csrc/deform.cu"
JAX_DEFORM = "db_text_minimal_tpu/models/deform.py"
PROBE = "benchmarks/int8_conv_probe.py"
# the int8 conv's launches per forward: one an int8 conv (17 with
# skip=()); with static scales 7 of them write the next conv's int8 input
INT8_CONVS, FUSED_PLACES = 17, 7
# the export phase: an archive serves batch 1 and batch N; the JAX export
# tests' rule (tests/test_cli_serve.py:215-217): at most 1 % of pixels more
# than 1e-3 apart from the live forward of the same mode
EXPORT_TOL, EXPORT_SHARE = 1e-3, 0.01
# the prune phase: the JAX package's p50 keeps and what its report gives
# for them (demo/hard_bench/prune_probe.json: widths and param ratio, a
# count of weights), and odd keeps whose widths leave K and N of the int8
# GEMMs off multiples of 8
P50_KEEPS = ("0.5", "0.75", "0.5")
P50_WIDTHS = {"backbone_hidden": [32, 32, 64, 64, 128, 128, 256, 256],
              "fpn_inner_quarter": 48, "head_width": 64, "fpn_out": 128}
P50_PARAM_RATIO = 0.5048
ODD_KEEPS = ("0.3", "1.0", "130")
PRUNE_STEPS = 3
TRAIN_BATCH, TRAIN_STEPS, LR = 4, 12, 0.005
# the launch counters of each device postprocess path; K4 runs twice on
# both (the foreground's and the 4-connected background's labels)
RECT_PATH = ("connected_components_8", "connected_components_4",
             "compact_slots", "hole_stats", "rotated_boxes")
POLY_PATH = ("connected_components_8", "connected_components_4",
             "compact_slots", "hole_stats", "bbox_stats", "pack_bits")
KERNEL_IDS = {"fused_db_step": "K1", "db_step_forward": "K2",
              "db_step_backward": "K2", "connected_components_8": "K3",
              "connected_components_4": "K3",
              "connected_components_8_served": "K3",
              "connected_components_4_served": "K3", "compact_slots": "K4",
              "compact_slots_served": "K4", "rotated_boxes": "K5",
              "rotated_boxes_served": "K5", "hole_stats": "K6",
              "hole_stats_served": "K6", "bbox_stats": "K7",
              "poly_stats": "K7", "poly_stats_served": "K7",
              "pack_bits": "K7", "pack_bits_w100": "K7", "fast_boxes": "K8",
              "int8_epilogue_f32": "P1", "int8_epilogue_int8": "P1",
              "deform_im2col": "D1", "deform_col2im": "D1"}


# the L2 flush between timed calls, and its kernel's name in the traces
L2_FLUSH_BYTES = 256 << 20
FLUSH_NAME = "_l2_flush_kernel"
# the quality phase: a small hard set at full width, the JAX report's keys
# (the config's with the compute dtype beside the backend)
QUALITY_TRAIN, QUALITY_TEST, QUALITY_BATCH = 32, 16, 16
REPORT_KEYS = ["config", "train_wall_s", "eval_wall_s", "history",
               "results"]
CONFIG_KEYS = ["eval_only", "checkpoint", "train_config", "thresh",
               "box_thresh", "unclip_ratio", "n_train", "n_test", "backend",
               "compute_dtype", "quant", "quant_head"]


# the ocr phase: full width, the crops of a batch, the train steps, and the
# fp32 tolerance of the card's logits against the CPU's (absolute; seeded
# random weights give logits under ~0.5)
REC_WIDTH = {"output_channel": 512, "hidden_size": 256,
             "batch_max_length": 25}
REC_CONFIGS = (("None", "VGG", "BiLSTM", "CTC"),
               ("None", "ResNet", "BiLSTM", "Attn"),
               ("TPS", "RCNN", "BiLSTM", "CTC"))
REC_BATCH, REC_TRAIN_BATCH, REC_STEPS, REC_TOL = 64, 32, 12, 1e-4
REC_KEYS = ["mode", "distort", "word_accuracy", "correct", "total",
            "mean_confidence", "sample_errors"]
E2E_KEYS = ["mode", "n_images", "n_gt_words", "n_detections",
            "det_precision", "det_recall", "det_hmean", "e2e_precision",
            "e2e_recall", "e2e_hmean"]


# the families phase: every other detector family the JAX package builds,
# at full width; the two run card against CPU and trained; the offset
# branches' std (zero at init); the card-against-CPU tolerance (fp32, TF32
# off: the calibrated 640² maps differ ~1e-6 between two summation orders)
FAMILY_SERVE = (("resnet34", "FPN"), ("resnet50", "FPN"),
                ("deformable_resnet18", "FPN"),
                ("deformable_resnet50", "FPN"), ("resnet101", "FPN"),
                ("resnet152", "FPN"), ("resnet18", "FPEM_FFM"))
FAMILY_CHECK = (("deformable_resnet50", "FPN"), ("resnet18", "FPEM_FFM"))
FAMILY_STEPS, FAMILY_TIMED_STEPS, FAMILY_REPS = 3, 5, 5
OFFSET_STD, FAMILY_TOL = 0.01, 1e-4
# the deformable convs of each deformable family: D1's launches a forward
# (im2col) and a backward (col2im); their forwards and a bf16 step at
# batch 16 timed with D1's kernels and with the plain function swapped in,
# in TURNS rounds of (kernel, plain)
DCN_CONVS = {"deformable_resnet18": 6, "deformable_resnet50": 13}
TURNS = 2


# the tools phase: the committed Flax fixture (tests/make_flax_fixture.py:
# a narrow detector written by the JAX package, its JAX maps of a seeded
# 64x64 input) held on the card in fp32 at the families' tolerance;
# cli/test's runs card against CPU (the flax mode bf16 on the card, fp32 on
# the CPU): binarized maps agreeing on TOOLS_AGREE of the pixels, resized
# prob maps within a mean TOOLS_GAP, box counts within TOOLS_BOXES of each
# other (or 2); webcam frames, pretrain steps, a cli.train epoch
FLAX_FIXTURE = "tests/fixtures/flax_det.ckpt"
FLAX_MAPS = "tests/fixtures/flax_det_maps.npy"
TOOLS_AGREE, TOOLS_GAP, TOOLS_BOXES = 0.99, 0.02, 0.2
TOOLS_FRAMES, PRETRAIN_STEPS, PRETRAIN_BATCH = 6, 8, 64
CLI_TEST_MODES = (("heatmap", ["--heatmap", "true"]),
                  ("polygon", ["--is_output_polygon", "true"]),
                  ("rect", ["--is_output_polygon", "false"]))


# the counter a row's kernel adds to, where it is not the row's own name
COUNTER = {"poly_stats": "bbox_stats", "pack_bits_w100": "pack_bits"}


def check_launches(launches: dict, path: tuple, what: str) -> None:
    """Every counter of ``path`` rose, and K4 ran for both label maps."""
    missing = [k for k in path if launches[k] == 0]
    if missing or launches["compact_slots"] < 2:
        raise AssertionError(f"{what}: kernels never launched {missing}, "
                             f"launches {launches}")


def log(msg: str) -> None:
    print(msg, flush=True)


def _l2_flush_kernel(ptr, n, BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)  # noqa: F821
    mask = offs < n
    tl.store(ptr + offs, tl.load(ptr + offs, mask=mask) + 1,  # noqa: F821
             mask=mask)


_FLUSH: dict = {}


def flush_l2() -> None:
    """Read and write a buffer of L2_FLUSH_BYTES, five times the H100's
    50 MB L2, so that the next call finds its inputs in device memory, as a
    caller that did other work in between does. Its Triton kernel,
    ``_l2_flush_kernel``, is left out of every device sum (FLUSH_NAME)."""
    if not _FLUSH:
        import triton
        import triton.language as tl

        globals()["tl"] = tl
        _FLUSH["kernel"] = triton.jit(_l2_flush_kernel)
        _FLUSH["buf"] = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                                    device="cuda")
    buf = _FLUSH["buf"]
    _FLUSH["kernel"][((buf.numel() + 4095) // 4096,)](buf, buf.numel(),
                                                      BLOCK=4096)


def timed(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs after two
    warm-up runs, from CUDA events around each run, with the L2 flushed
    before each (``flush_l2``, outside the events)."""
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def device_kernels(fn, reps: int) -> tuple[float, dict, float]:
    """Device time of ``fn`` from torch.profiler: the card's activity
    (kernels, copies, fills) per call in ms, ms per call by kernel name,
    and device operations per call, over ``reps`` calls after one warm-up
    call, the L2 flushed before each call (the flush's kernel is not
    counted). A trace that holds no device activity at all (the profiler
    now and then drops a whole window) is taken again, up to three
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name: dict = {}
    ops = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush_l2()
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and FLUSH_NAME not in e.name:
                ops += 1
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3 / reps)
        if by_name:
            break
    return sum(by_name.values()), by_name, ops / reps


def draw_rect(prob, cx, cy, w, h, deg, val):
    th = np.deg2rad(deg)
    ys, xs = np.mgrid[0:prob.shape[0], 0:prob.shape[1]]
    dx, dy = xs - cx, ys - cy
    u = dx * np.cos(th) + dy * np.sin(th)
    v = -dx * np.sin(th) + dy * np.cos(th)
    prob[(np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)] = val


def kernel_scene(i: int, size: int = SIZE) -> np.ndarray:
    """Prob map with background noise below thresh, 8 rotated rects, 140
    speckles and a 640² spiral (even i) or a ring with a nested blob (odd
    i)."""
    rng = np.random.RandomState(SEED + i)
    p = (rng.rand(size, size) * 0.2).astype(np.float32)
    for _ in range(8):
        draw_rect(p, rng.randint(size // 8, size - size // 8),
                  rng.randint(size // 8, size - size // 8),
                  rng.randint(size // 20, size // 4), rng.randint(8, 30),
                  rng.uniform(-60, 60), rng.uniform(0.6, 0.95))
    for _ in range(140):
        x, y = rng.randint(2, size - 3), rng.randint(2, size - 3)
        p[y:y + 2, x:x + 2] = np.maximum(p[y:y + 2, x:x + 2], 0.4)
    c = size // 2
    if i % 2 == 0:
        th = np.linspace(0, 6 * np.pi, 4000)
        r = 10 + th * 8 * size / 640
        for x, y in zip((c + r * np.cos(th)).astype(int),
                        (c + r * np.sin(th)).astype(int)):
            if 4 <= x < size - 4 and 4 <= y < size - 4:
                p[y - 3:y + 4, x - 3:x + 4] = 0.85
    else:
        q = size // 10
        p[c - 3 * q:c + 3 * q, c - 3 * q:c + 3 * q] = 0.55
        p[c - 2 * q:c + 2 * q, c - 2 * q:c + 2 * q] = 0.05
        p[c - q // 2:c + q // 2, c - q // 2:c + q // 2] = 0.95
    return p


def db_step_maps():
    """P and T of the training shapes from a seed, with k(P - T) at its
    ends, +50 and -50, and P at the bitmap's threshold in the first
    pixels."""
    g = torch.Generator().manual_seed(SEED)
    p = torch.rand((TRAIN_BATCH, 1, SIZE, SIZE), generator=g)
    t = torch.rand((TRAIN_BATCH, 1, SIZE, SIZE), generator=g)
    p.view(-1)[:4] = torch.tensor([1.0, 0.0, 0.3, 0.30000001])
    t.view(-1)[:4] = torch.tensor([0.0, 1.0, 0.3, 0.3])
    grad = torch.randn((TRAIN_BATCH, SIZE, SIZE, 3), generator=g)
    dev = torch.device("cuda")
    # the gradient of B̂ as the loss hands it to K2's backward: the last
    # channel of the NHWC output, element stride 3
    return p.to(dev), t.to(dev), grad.to(dev).permute(0, 3, 1, 2)[:, 2:3]


def build_triton() -> None:
    """Compile K1 and K2 (forward, backward): Triton compiles a kernel at
    its first launch, here at the training shapes."""
    p, t, grad = db_step_maps()
    D.fused_db_step(p[:, 0], t[:, 0])
    D.db_step_backward(grad, D.db_step_forward(p, t))
    torch.cuda.synchronize()


def phase_build() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        jobs = [pool.submit(cc.load_library),
                pool.submit(I8.load_library),
                pool.submit(I8.load_library, "int8_conv"),
                pool.submit(DF.load_library),
                pool.submit(geometry.load_library),
                pool.submit(build_triton)]
        for job in jobs:
            job.result()
    log(f"build ok: cc.cu, int8_epilogue.cu, int8_conv.cu and deform.cu "
        f"(nvcc sm_90a), "
        f"geometry.cpp "
        f"(g++) and K1, K2 forward and backward (Triton) in "
        f"{time.perf_counter() - t0:.2f} s")


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, route, source, replaces, err, tol, kernel, plain,
               bytes_moved, ops) -> dict:
    """Hold a kernel to its tolerance, time it and its plain version, and
    give its row of the kernels line (launches are filled in later).
    ``ms`` is the time per call of back-to-back calls from CUDA events,
    host launch cost included; ``device_ms`` the card's own activity per
    call, from torch.profiler. ``plain`` is the plain version on the card,
    or its time in ms where it was measured elsewhere."""
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    ms = timed(kernel, 20)
    plain_ms = plain if isinstance(plain, float) else timed(plain, 3)
    dev_ms, by_name, _ = device_kernels(kernel, 20)
    split = {short_name(k): v for k, v in by_name.items()}
    bound_ms, bound_by = bound(bytes_moved, ops)
    log(f"kernel {name}: max_abs_err {err} (tolerance {tol}), "
        f"{ms:.4f} ms, on the card {dev_ms:.4f} ms, plain {plain_ms:.3f} "
        f"ms, bound {bound_ms:.4f} ms ({bound_by}); on the card by launch "
        f"ms {json.dumps({k: round(v, 4) for k, v in split.items()})}")
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": float(err),
            "ms": ms, "device_ms": dev_ms, "device_split": split,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def short_name(kernel: str) -> str:
    """A profiler kernel name without its namespace, return type and
    arguments: "(anonymous namespace)::k3_local(unsigned char const*, ...)"
    -> "k3_local"."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    head, bracket, args = name.partition("<")
    name = head.split("::")[-1] + bracket + args
    return name.removeprefix("void ").strip() or kernel[:60]


def phase_kernels() -> list[dict]:
    dev = torch.device("cuda")
    prob = torch.from_numpy(
        np.stack([kernel_scene(i) for i in range(N)])).to(dev)
    mask = prob > 0.3
    px = N * SIZE * SIZE
    rows = []

    def record(name, replaces, err, tol, kernel, plain, bytes_moved, ops):
        rows.append(kernel_row(name, "cuda", SRC, f"{JAX_CC}:{replaces}",
                               err, tol, kernel, plain, bytes_moved, ops))

    # K3: labels exact; 8-connected on the foreground, 4-connected on the
    # background (the main path runs both, the second for K6)
    labels = cc.connected_components(mask)
    err = (labels - cc.connected_components_plain(mask)).abs().max().item()
    record("connected_components_8", 64, err, 0,
           lambda: cc.connected_components(mask),
           lambda: cc.connected_components_plain(mask),
           px * (1 + 4), px * 8)
    bg_labels = cc.connected_components(~mask, 4)
    err = (bg_labels - cc.connected_components_plain(~mask, 4)).abs().max()
    record("connected_components_4", 64, err.item(), 0,
           lambda: cc.connected_components(~mask, 4),
           lambda: cc.connected_components_plain(~mask, 4),
           px * (1 + 4), px * 4)

    # K4 timed on the foreground labels; the main path runs it on both
    # label maps. K6, the route step alone on the background's slots.
    rows.append(k4_row("compact_slots", labels))
    keyed, valid_root = cc.compact_slots(labels, K)
    bg_keyed, _ = cc.compact_slots(bg_labels, K)
    row, hole, hole_p = k6_row("hole_stats", mask, keyed, bg_keyed, prob)
    rows.append(row)

    # K5, held to its plain version on the same inputs (check_k5)
    out = cc.rotated_boxes(prob, keyed, valid_root, *hole, K)
    out_p = cc.rotated_boxes_plain(prob, keyed, valid_root, *hole_p, K)
    err = check_k5(out, out_p, "rotated_boxes")
    record("rotated_boxes", 184, err, 1e-3,
           lambda: cc.rotated_boxes(prob, keyed, valid_root, *hole, K),
           lambda: cc.rotated_boxes_plain(prob, keyed, valid_root, *hole_p,
                                          K),
           *k5_work(keyed, SIZE))
    log(f"kernels ok: {int(out_p[3].sum())} valid components over {N} maps "
        f"of {SIZE}x{SIZE}, {int((keyed < K).sum())} foreground pixels")
    return rows


def k4_row(name: str, labels: torch.Tensor) -> dict:
    """K4 on ``labels`` against its plain version: slots and valid roots
    exact. Bytes: the label read and the slot written, 8 B a pixel, and a
    byte a valid root."""
    keyed, valid_root = cc.compact_slots(labels, K)
    keyed_p, valid_root_p = cc.compact_slots_plain(labels, K)
    err = max((keyed - keyed_p).abs().max().item(),
              (valid_root ^ valid_root_p).sum().item())
    px = labels.numel()
    row = kernel_row(name, "cuda", SRC, f"{JAX_CC}:114", err, 0,
                     lambda: cc.compact_slots(labels, K),
                     lambda: cc.compact_slots_plain(labels, K),
                     px * (4 + 4) + labels.shape[0] * K, px * 4)
    # one PyTorch call ranks the labels as K4 does (over the batch, not
    # per image, and without the slot cap)
    row["library_ms"] = timed(
        lambda: torch.unique(labels, sorted=True, return_inverse=True), 5)
    row["note"] = ("library_ms: torch.unique(labels, sorted=True, "
                   "return_inverse=True)")
    return row


def k6_row(name, mask, keyed, bg_keyed, prob):
    """K6 against its plain version: hole counts exact; hole sums are f64
    sums rounded to f32, so the kernel's atomic order may move them by an
    ulp. It reads the mask and both slot maps at every pixel and prob at
    the hole pixels only. Returns the row and both results."""
    hole = cc.hole_stats(mask, keyed, bg_keyed, prob, K)
    hole_p = cc.hole_stats_plain(mask, keyed, bg_keyed, prob, K)
    if not torch.equal(hole[1], hole_p[1]):
        raise AssertionError(f"{name}: hole counts differ")
    err = (hole[0] - hole_p[0]).abs().max().item()
    tol = 1e-6 * max(1.0, hole_p[0].abs().max().item())
    px = mask.numel()
    hole_px = int(hole_p[1].sum().item())
    bg_px = int((~mask).sum().item())
    row = kernel_row(
        name, "cuda", SRC, f"{JAX_CC}:383", err, tol,
        lambda: cc.hole_stats(mask, keyed, bg_keyed, prob, K),
        lambda: cc.hole_stats_plain(mask, keyed, bg_keyed, prob, K),
        px * (1 + 4 + 4) + hole_px * 4 + mask.shape[0] * K * 8,
        bg_px * 8 + px)
    return row, hole, hole_p


def check_k5(out, ref, what: str) -> float:
    """K5 against its plain version: valid slots exact, scores within 1e-6
    (the prob sums are f64 sums in atomic order, rounded to f32), corners
    and sides of the valid slots within 1e-3 px (the angle picks match).
    Returns the corner and side error."""
    valid = ref[3]
    if not torch.equal(out[3], valid):
        raise AssertionError(f"{what}: valid slots differ")
    score_err = (out[2] - ref[2]).abs().max().item()
    if score_err > 1e-6:
        raise AssertionError(f"{what}: score error {score_err}")
    gaps = torch.cat([(out[0] - ref[0])[valid].flatten(),
                      (out[1] - ref[1])[valid].flatten()])
    err = gaps.abs().max().item() if gaps.numel() else 0.0
    if not err <= 1e-3:
        raise AssertionError(f"{what}: corners or sides {err} px apart")
    return err


def k5_work(keyed: torch.Tensor, w: int) -> tuple[int, int]:
    """The bytes K5 must move (slot map and prob in, 54 B a slot out) and
    the operations this input needs: about 12 a foreground pixel for the
    moments, and 10 a candidate angle at each of the two extreme pixels of
    every (slot, row) that holds a pixel."""
    n, hw = keyed.shape
    key = keyed.long()
    fg = key < K
    rows = torch.arange(hw, device=keyed.device) // w
    pair = (torch.arange(n, device=keyed.device)[:, None] * (K + 1)
            + key) * (hw // w) + rows
    points = 2 * torch.unique(pair[fg]).numel()
    candidates = sum(len(o) for o in cc.stage_offsets())
    return (n * hw * (4 + 4) + n * K * 54,
            int(fg.sum()) * 12 + points * candidates * 10)


# K3's hard masks, the same as tests/torch_scenes.K3_SWEEP: the kernel works
# on tiles of 32 rows by 128 columns, so the diagonals run through every
# tile corner both ways, and the serpentines cross every tile border with
# 1-px runs; noise near the percolation thresholds
K3_SWEEP = ("ones", "zeros", "checkerboard", "diagonals", "antidiagonals",
            "serpentine_rows", "serpentine_cols", "noise_0.41", "noise_0.5",
            "noise_0.59")


def serpentine_mask(h: int, w: int) -> np.ndarray:
    """1-px corridors (even rows) between 1-px walls (odd rows), each wall
    open at one end, the ends alternating: one path through the map."""
    m = np.zeros((h, w), bool)
    m[0::2] = True
    m[1::4, -1] = True
    m[3::4, 0] = True
    return m


def k3_sweep_mask(name: str, h: int, w: int, seed: int) -> np.ndarray:
    ys, xs = np.mgrid[0:h, 0:w]
    if name.startswith("noise_"):
        return np.random.RandomState(seed).rand(h, w) < float(name[6:])
    if name == "serpentine_cols":
        return serpentine_mask(w, h).T.copy()
    return {"ones": lambda: np.ones((h, w), bool),
            "zeros": lambda: np.zeros((h, w), bool),
            "checkerboard": lambda: (ys + xs) % 2 == 0,
            "diagonals": lambda: (xs - ys) % 32 == 0,
            "antidiagonals": lambda: (xs + ys) % 32 == 31,
            "serpentine_rows": lambda: serpentine_mask(h, w)}[name]()


def phase_k3_sweep() -> None:
    """K3 against its plain version, bit for bit, both connectivities, on
    its hard masks at 8x640x640 and at a ragged 8x637x641 (tiles cut on
    both axes), each image's noise from its own seed."""
    dev = torch.device("cuda")
    checked = 0
    for h, w in ((SIZE, SIZE), (637, 641)):
        for name in K3_SWEEP:
            mask = torch.from_numpy(np.stack([
                k3_sweep_mask(name, h, w, SEED + i) for i in range(N)]))
            mask = mask.to(dev)
            for conn in (8, 4):
                if not torch.equal(cc.connected_components(mask, conn),
                                   cc.connected_components_plain(mask, conn)):
                    raise AssertionError(
                        f"K3 sweep: {name} at {N}x{h}x{w}, {conn}-connected, "
                        f"differs from the plain version")
                checked += 1
    log(f"k3 sweep ok: {checked} cases ({len(K3_SWEEP)} masks, 8- and "
        f"4-connected, at {N}x{SIZE}x{SIZE} and {N}x637x641) equal to the "
        f"plain version bit for bit")


def k5_inputs(prob: torch.Tensor, mask: torch.Tensor):
    """K5's inputs as the rect path makes them from a mask, by the kernels:
    K3 -> K4 on the foreground, K3/K4 on the 4-connected background -> K6.
    Returns (keyed, valid_root, hole_sum, hole_cnt)."""
    keyed, valid_root = cc.compact_slots(cc.connected_components(mask), K)
    bg_keyed, _ = cc.compact_slots(cc.connected_components(~mask, 4), K)
    return (keyed, valid_root) + cc.hole_stats(mask, keyed, bg_keyed, prob, K)


def bars_map(h: int, w: int, i: int) -> np.ndarray:
    """Prob map of 12 rotated bars at 0, 90, +-45 degrees and at small
    angles near 0, where neighbouring candidate angles tie on area and the
    first minimum decides; image i shifts their lengths and widths."""
    p = np.full((h, w), 0.1, np.float32)
    angles = (0.0, 90.0, 45.0, -45.0, 0.25, -0.25, 0.5, -0.5, 1.0, -1.0,
              3.0, -3.0)
    for j, deg in enumerate(angles):
        cy = (j // 4 + 0.5) * h / 3
        cx = (j % 4 + 0.5) * w / 4
        draw_rect(p, cx, cy, min(w // 5, h // 4) + 3 * i, 6 + i, deg,
                  0.6 + 0.02 * j)
    return p


def phase_k5_sweep() -> None:
    """K5 against its plain version along the rect path (K3 -> K4 -> K3/K4
    on the background -> K6 -> K5) on K3's hard masks, with prob drawn from
    the seed, and on the bar maps, at 8x640x640 and at a ragged 8x637x641:
    valid slots exact, corners and sides within 1e-3 px, scores within
    1e-6 (check_k5)."""
    dev = torch.device("cuda")
    checked, worst = 0, 0.0
    for h, w in ((SIZE, SIZE), (637, 641)):
        for name in K3_SWEEP + ("bars",):
            if name == "bars":
                prob = np.stack([bars_map(h, w, i) for i in range(N)])
                mask = prob > 0.3
            else:
                mask = np.stack([k3_sweep_mask(name, h, w, SEED + i)
                                 for i in range(N)])
                prob = np.random.RandomState(SEED).rand(N, h, w)
            prob = torch.from_numpy(prob.astype(np.float32)).to(dev)
            mask = torch.from_numpy(mask).to(dev)
            keyed, valid_root, hole_sum, hole_cnt = k5_inputs(prob, mask)
            args = (prob, keyed, valid_root, hole_sum, hole_cnt, K)
            worst = max(worst, check_k5(cc.rotated_boxes(*args),
                                        cc.rotated_boxes_plain(*args),
                                        f"K5 sweep: {name} at {N}x{h}x{w}"))
            checked += 1
    log(f"k5 sweep ok: {checked} cases ({len(K3_SWEEP)} masks and the bar "
        f"maps at {N}x{SIZE}x{SIZE} and {N}x637x641) against the plain "
        f"version, corners and sides within {worst:.3g} px")


def phase_served(preds: torch.Tensor) -> list[dict]:
    """K3-K7 rows on the served batch's maps at the handler's threshold
    0.3: K3 on the 8-connected foreground and the 4-connected background,
    as the rect and polygon paths label them, K4 on the foreground labels,
    K6 on the slot maps of both, K5 on the slot maps that the rect path
    gives it and the K7 stats in the polygon path's form (K = 1000)."""
    prob = preds[..., 0].contiguous()
    mask = prob > 0.3
    px = mask.numel()
    rows = []
    for conn, m in ((8, mask), (4, ~mask)):
        err = (cc.connected_components(m, conn)
               - cc.connected_components_plain(m, conn)).abs().max().item()
        rows.append(kernel_row(
            f"connected_components_{conn}_served", "cuda", SRC, f"{JAX_CC}:64",
            err, 0, lambda m=m, conn=conn: cc.connected_components(m, conn),
            lambda m=m, conn=conn: cc.connected_components_plain(m, conn),
            px * (1 + 4), px * conn))
    labels = cc.connected_components(mask)
    rows.append(k4_row("compact_slots_served", labels))
    keyed, _ = cc.compact_slots(labels, K)
    bg_keyed, _ = cc.compact_slots(cc.connected_components(~mask, 4), K)
    row, hole, _ = k6_row("hole_stats_served", mask, keyed, bg_keyed, prob)
    rows.append(row)
    args = (prob,) + k5_inputs(prob, mask) + (K,)
    out_p = cc.rotated_boxes_plain(*args)
    rows.append(kernel_row(
        "rotated_boxes_served", "cuda", SRC, f"{JAX_CC}:184",
        check_k5(cc.rotated_boxes(*args), out_p, "rotated_boxes_served"),
        1e-3, lambda: cc.rotated_boxes(*args),
        lambda: cc.rotated_boxes_plain(*args), *k5_work(args[1], SIZE)))
    rows.append(poly_stats_row("poly_stats_served", prob, keyed, args[2],
                               hole))
    log(f"served k3-k7 ok: {int(mask.sum())} of {px} pixels set over "
        f"{N} maps, {int(out_p[3].sum())} valid slots")
    return rows


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the host clock over ``reps`` runs
    after one warm-up run, for work that runs on the CPU."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_poly_kernels() -> list[dict]:
    """K7's kernels at the serving shapes (the stats kernel over the K4
    slots in its bbox_stats form and in its poly_stats form, which folds in
    the hole-filled scores and valid flags, and the bit-pack of the bitmap)
    and the bit-pack at width 100 (rows padded to 13 bytes) against their
    plain versions on the card: counts, bboxes, valid flags and packed
    bytes exact, prob sums (f64) within 1e-9 of their size, scores within
    1e-6. K8's fast_boxes (K3, K4 and the bbox statistics with its filter)
    against the same call on the CPU, where the wrappers run their plain
    versions: boxes and keep exact, scores within 1e-6."""
    dev = torch.device("cuda")
    prob = torch.from_numpy(
        np.stack([kernel_scene(i) for i in range(N)])).to(dev)
    mask = prob > 0.3
    px = N * SIZE * SIZE
    keyed, valid_root = cc.compact_slots(cc.connected_components(mask), K)
    rows = []

    cnt, psum, bbox = cc.bbox_stats(keyed, prob, K)
    cnt_p, psum_p, bbox_p = cc.bbox_stats_plain(keyed, prob, K)
    if not (torch.equal(cnt, cnt_p) and torch.equal(bbox, bbox_p)):
        raise AssertionError("bbox_stats: counts or bboxes differ")
    rows.append(kernel_row(
        "bbox_stats", "cuda", SRC, f"{JAX_CC}:448",
        (psum - psum_p).abs().max().item(),
        1e-9 * max(1.0, psum_p.abs().max().item()),
        lambda: cc.bbox_stats(keyed, prob, K),
        lambda: cc.bbox_stats_plain(keyed, prob, K),
        px * (4 + 4) + N * K * (4 + 8 + 16), px * 8))
    bg_keyed, _ = cc.compact_slots(cc.connected_components(~mask, 4), K)
    rows.append(poly_stats_row("poly_stats", prob, keyed, valid_root,
                               cc.hole_stats(mask, keyed, bg_keyed, prob, K)))

    for name, m in (("pack_bits", mask),
                    ("pack_bits_w100", mask[:, :100, :100].contiguous())):
        packed = cc.pack_bits(m)
        err = (packed.int() - cc.pack_bits_plain(m).int()).abs().max().item()
        rows.append(kernel_row(
            name, "cuda", SRC, f"{JAX_CC}:482", err, 0,
            lambda m=m: cc.pack_bits(m), lambda m=m: cc.pack_bits_plain(m),
            m.numel() + packed.numel(), m.numel() * 2))

    boxes, scores, keep = cc.fast_boxes(prob)
    ref = cc.fast_boxes(prob.cpu())
    if not (torch.equal(boxes.cpu(), ref[0]) and torch.equal(keep.cpu(),
                                                             ref[2])):
        raise AssertionError("fast_boxes: boxes or keep differ from the CPU")
    err = (scores.cpu() - ref[1]).abs().max().item()
    if not err <= 1e-6:
        raise AssertionError(f"fast_boxes: score error {err}")
    # the K8 row's plain time is the same call on the CPU tensors, which
    # run the plain versions (one warm-up, two runs: each takes a second)
    cpu_prob = prob.cpu()
    row = kernel_row("fast_boxes", "cuda", SRC, f"{JAX_CC}:506", err, 1e-6,
                     lambda: cc.fast_boxes(prob),
                     host_ms(lambda: cc.fast_boxes(cpu_prob), 2),
                     px * 4 + N * K * (16 + 4 + 1), px * 12)
    row["note"] = ("no path of the package calls K8; plain_ms is the same "
                   "call on the host CPU, where the wrappers run their "
                   "plain versions")
    rows.append(row)
    log(f"poly kernels ok: {int(keep.sum())} fast boxes kept over {N} maps "
        f"of {SIZE}x{SIZE}; plain fast_boxes on the CPU "
        f"{row['plain_ms']:.1f} ms")
    return rows


def poly_stats_row(name, prob, keyed, valid_root, hole) -> dict:
    """The K7 stats kernel with the polygon path's epilogue against its
    plain version: bboxes and valid exact, scores within 1e-6 (f64 sums in
    atomic order may round to another f32). Bytes: the slot map and prob
    read, 8 B a pixel, valid_root and the hole sums and counts read (9 B a
    slot), bboxes, scores and valid written (21 B a slot)."""
    args = (keyed, valid_root, prob) + tuple(hole) + (K,)
    out, ref = cc.poly_stats(*args), cc.poly_stats_plain(*args)
    if not (torch.equal(out[0], ref[0]) and torch.equal(out[2], ref[2])):
        raise AssertionError(f"{name}: bboxes or valid slots differ")
    px, slots = prob.numel(), prob.shape[0] * K
    return kernel_row(
        name, "cuda", SRC, f"{JAX_CC}:448",
        (out[1] - ref[1]).abs().max().item(), 1e-6,
        lambda: cc.poly_stats(*args), lambda: cc.poly_stats_plain(*args),
        px * 8 + slots * (4 + 4 + 1) + slots * (16 + 4 + 1), px * 8)


def phase_drivers() -> None:
    """The two batched drivers that compose the kernels, K9 device_boxes
    (rect mode) and K7 device_poly_stats (polygon mode), at the serving
    shapes on the kernel scenes: time per call by events and on the card,
    the same call on the CPU (the plain versions), and the bound from the
    bytes each must move (read the f32 map once, write its records and, for
    K7, the packed bitmap), with the device operations (kernels, memsets,
    copies) a call of each makes."""
    prob = torch.from_numpy(np.stack([kernel_scene(i) for i in range(N)]))
    px = N * SIZE * SIZE
    on_card = prob.to(torch.device("cuda"))
    for name, fn, out_bytes in (
            ("device_boxes", cc.device_boxes, N * K * (32 + 4 + 1)),
            ("device_poly_stats", cc.device_poly_stats,
             px // 8 + N * K * (16 + 4 + 1))):
        ms = timed(lambda: fn(on_card), 20)
        dev_ms, _, ops = device_kernels(lambda: fn(on_card), 20)
        cpu_ms = host_ms(lambda: fn(prob), 2)
        bound_ms, bound_by = bound(px * 4 + out_bytes, 0)
        log(f"driver {name} at {N}x{SIZE}x{SIZE}: {ms:.4f} ms, on the card "
            f"{dev_ms:.4f} ms in {ops:g} device operations a call, on the "
            f"CPU (plain versions) {cpu_ms:.1f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")


def phase_db_step_kernels() -> list[dict]:
    """K1, K2 forward and K2 backward at the training shapes. B̂ within
    1e-6 (the kernels' exp is the card's fast one), the bitmap exact, dP
    and dT within 1e-6 of max(1, max|g|). Bytes: K1 reads P, T and writes
    B̂ and the bitmap, 16 B a pixel; K2 forward 12 B; K2 backward reads g
    (strided: all 12 B a pixel of the output's gradient) and B̂ and
    writes dP and dT, 24 B."""
    p, t, grad = db_step_maps()
    px = p.numel()
    rows = []
    bhat, bitmap = D.fused_db_step(p[:, 0], t[:, 0])
    bhat_p, bitmap_p = D.fused_db_step_plain(p[:, 0], t[:, 0])
    if not torch.equal(bitmap, bitmap_p):
        raise AssertionError("fused_db_step: bitmaps differ")
    rows.append(kernel_row(
        "fused_db_step", "triton", TRITON_SRC, f"{JAX_DB_STEP}:36",
        (bhat - bhat_p).abs().max().item(), 1e-6,
        lambda: D.fused_db_step(p[:, 0], t[:, 0]),
        lambda: D.fused_db_step_plain(p[:, 0], t[:, 0]), px * 16, px * 6))
    rows[-1]["note"] = "no path of the package calls K1"

    bhat = D.db_step_forward(p, t)
    bhat_p = D.db_step_forward_plain(p, t)
    ends = bhat.view(-1)[:2].tolist()
    if not (ends[0] == 1.0 and ends[1] < 1e-21):
        raise AssertionError(f"db_step_forward: sigmoid at +-50 gives {ends}")
    rows.append(kernel_row(
        "db_step_forward", "triton", TRITON_SRC, f"{JAX_DB_STEP}:76",
        (bhat - bhat_p).abs().max().item(), 1e-6,
        lambda: D.db_step_forward(p, t),
        lambda: D.db_step_forward_plain(p, t), px * 12, px * 5))

    dp, dt = D.db_step_backward(grad, bhat)
    dp_p, dt_p = D.db_step_backward_plain(grad, bhat)
    err = max((dp - dp_p).abs().max().item(), (dt - dt_p).abs().max().item())
    # the gradient is the last channel of the NHWC (P, T, B) output's f32
    # gradient, at element stride 3: every 32-byte sector of that tensor
    # holds some of it, so the card reads all 12 B a pixel of it; with B
    # read and dP, dT written, 24 B a pixel
    rows.append(kernel_row(
        "db_step_backward", "triton", TRITON_SRC, f"{JAX_DB_STEP}:114",
        err, 1e-6 * max(1.0, grad.abs().max().item()),
        lambda: D.db_step_backward(grad, bhat),
        lambda: D.db_step_backward_plain(grad, bhat), px * 24, px * 5))
    log(f"db step kernels ok at {TRAIN_BATCH}x1x{SIZE}x{SIZE}; the "
        f"backward's gradient has element stride "
        f"{D.uniform_stride(grad)}")
    return rows


def epilogue_inputs(m: int, c: int):
    """int32 accumulators drawn from a seed over the range of a 3x3 conv of
    256 int8 channels (|acc| <= 2304 * 127^2 < 2^26), and per-channel
    scales and biases as a calibrated conv has them, on the card."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev = torch.device("cuda")
    acc = torch.randint(-2 ** 25, 2 ** 25, (m, c), generator=g,
                        dtype=torch.int32, device=dev)
    scale = torch.rand(c, generator=g, device=dev) * 2e-6
    bias = torch.randn(c, generator=g, device=dev) * 0.5
    return acc, scale, bias


def phase_int8_kernels() -> list[dict]:
    """P1 in both forms at the int8 forward's shapes, bit for bit against
    its plain version on the card: the f32 form at the FPN output conv's
    output (8x160x160x256; reads 4 B and writes 4 B an element) and the
    int8 form at a layer-2 conv1's (8x80x80x128, at an output scale that
    clips some values; 4 B in, 1 B out)."""
    rows = []
    for name, (n, h, w, c), out_scale, per_elem, ops in (
            ("int8_epilogue_f32", (N, SIZE // 4, SIZE // 4, 256), None, 8, 3),
            ("int8_epilogue_int8", (N, SIZE // 8, SIZE // 8, 128), 0.25, 5,
             6)):
        m = n * h * w
        acc, scale, bias = epilogue_inputs(m, c)
        osc = (None if out_scale is None
               else torch.tensor(out_scale, device=acc.device))
        out = I8.int8_epilogue(acc, scale, bias, True, osc)
        ref = I8.int8_epilogue_plain(acc, scale, bias, True, osc)
        if out.dtype != ref.dtype or not torch.equal(out, ref):
            raise AssertionError(f"{name}: the kernel differs from its "
                                 f"plain version")
        row = kernel_row(
            name, "cuda", INT8_SRC, f"{PROBE}:111",
            (out.float() - ref.float()).abs().max().item(), 0,
            lambda: I8.int8_epilogue(acc, scale, bias, True, osc),
            lambda: I8.int8_epilogue_plain(acc, scale, bias, True, osc),
            m * c * per_elem + c * 8, m * c * ops)
        row["shape"] = [n, h, w, c]
        row["note"] = ("library_ms null: no single PyTorch call computes "
                       "the epilogue; plain_ms is its plain version, 4 "
                       "(f32) or 8 (int8) ATen launches")
        rows.append(row)
        del acc, out, ref
    log("int8 kernels ok: P1 bit-equal to its plain version in both forms")
    return rows


# the int8 forward's convs at batch N, 640x640, skip=(): (input size, Cin,
# Cout, k, stride, convs of the shape, forms); the int8 form where the
# static forward feeds the next conv (each block's conv1, the FPN output
# conv)
INT8_CONV_SHAPES = (
    (SIZE // 4, 64, 128, 3, 2, 1, ("f32", "int8")),     # layer2_0 conv1
    (SIZE // 8, 128, 128, 3, 1, 3, ("f32", "int8")),    # layer2's other 3x3
    (SIZE // 4, 64, 128, 1, 2, 1, ("f32",)),            # layer2_0 downsample
    (SIZE // 8, 128, 256, 3, 2, 1, ("f32", "int8")),    # layer3_0 conv1
    (SIZE // 16, 256, 256, 3, 1, 3, ("f32", "int8")),
    (SIZE // 8, 128, 256, 1, 2, 1, ("f32",)),
    (SIZE // 16, 256, 512, 3, 2, 1, ("f32", "int8")),   # layer4_0 conv1
    (SIZE // 32, 512, 512, 3, 1, 3, ("f32", "int8")),
    (SIZE // 16, 256, 512, 1, 2, 1, ("f32",)),
    (SIZE // 4, 256, 256, 3, 1, 1, ("f32", "int8")),    # the FPN output conv
    (SIZE // 4, 256, 128, 3, 1, 1, ("f32",)))           # the head's conv1
INT8_CONV_SRC = "db_text_minimal_tpu_torch/csrc/int8_conv.cu"
JAX_INT8_CONV = "db_text_minimal_tpu/models/quant_infer.py:238"


def int8_conv_inputs(h: int, cin: int, cout: int, k: int):
    """A conv's int8 input (N, h, h, cin) and (kh, kw, cin) weights drawn
    from a seed, scales and biases as a calibrated conv has them, on the
    card."""
    g = torch.Generator(device="cuda").manual_seed(SEED + h + cin + k)
    dev = torch.device("cuda")
    q = torch.randint(-127, 128, (N, h, h, cin), generator=g,
                      dtype=torch.int8, device=dev)
    w = torch.randint(-127, 128, (cout, k * k * cin), generator=g,
                      dtype=torch.int8, device=dev)
    scale = torch.rand(cout, generator=g, device=dev) * 2e-6
    bias = torch.randn(cout, generator=g, device=dev) * 0.5
    return q, w, scale, bias


def phase_int8_conv_kernels() -> list[dict]:
    """The int8 conv (csrc/int8_conv.cu) at every distinct conv shape of
    the int8 forward at batch N, in each form the forward uses (the int8
    form at an output scale that clips), bit for bit against its plain
    version on the card (im2col, torch._int_mm, P1's plain version); each
    timed cold by events and device time, beside the route it replaces
    (im2col, torch._int_mm, P1's kernel) and its bound: int8 operations at
    the card's int8 tensor-core rate against each input read once and the
    output written once."""
    rows = []
    for h, cin, cout, k, stride, convs, forms in INT8_CONV_SHAPES:
        pad = k // 2
        q, w, scale, bias = int8_conv_inputs(h, cin, cout, k)
        ho = (h + 2 * pad - k) // stride + 1
        m, kk = N * ho * ho, k * k * cin
        for form in forms:
            osc = (torch.tensor(0.005, device=q.device) if form == "int8"
                   else None)
            args = (q, w, k, stride, pad, scale, bias, True, osc)

            def kernel():
                return I8.int8_conv(*args)

            def plain():
                return I8.int8_conv_plain(*args)

            def replaced():
                acc = I8.int8_conv2d(q, w, k, stride, pad)
                return I8.int8_epilogue(acc.view(-1, cout), scale, bias,
                                        True, osc)

            name = f"int8_conv_{form}_{h}x{cin}to{cout}_k{k}s{stride}"
            out, ref = kernel(), plain()
            if (out.dtype != ref.dtype or not torch.equal(out, ref)
                    or not torch.equal(replaced().view(out.shape), ref)):
                raise AssertionError(f"{name}: the kernel differs from its "
                                     f"plain version")
            if form == "int8" and out.max().item() != 127:
                raise AssertionError(f"{name}: the int8 form never clips")
            ms = timed(kernel, 20)
            dev_ms, by_name, _ = device_kernels(kernel, 10)
            plain_ms = timed(plain, 3)
            replaced_ms = timed(replaced, 10)
            replaced_dev_ms, replaced_split, _ = device_kernels(replaced, 5)
            moved = (q.numel() + w.numel() + out.numel() * out.element_size()
                     + cout * 8)
            bound_ms, bound_by = bound(moved, 2 * m * cout * kk,
                                       INT8_OPS_PER_S)
            log(f"kernel {name} (x{convs} a forward): bit-equal to its plain "
                f"version, {ms:.4f} ms, on the card {dev_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}, "
                f"{100 * bound_ms / dev_ms:.1f} % of it), "
                f"{2 * m * cout * kk / dev_ms / 1e9:.1f} TOP/s; the route "
                f"it replaces {replaced_ms:.4f} ms, on the card "
                f"{replaced_dev_ms:.4f} ms "
                f"{json.dumps({short_name(n)[:40]: round(v, 4) for n, v in replaced_split.items()})}; "
                f"plain {plain_ms:.3f} ms")
            rows.append({
                "name": name, "route": "cuda", "source": INT8_CONV_SRC,
                "replaces": f"{PROBE}:103", "launches": 0,
                "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
                "device_split": {short_name(n): v
                                 for n, v in by_name.items()},
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
                "replaced_ms": replaced_ms,
                "replaced_device_ms": replaced_dev_ms,
                "shape": [N, h, h, cin, cout, k, stride], "form": form,
                "convs": convs,
                "note": (f"_epi_kernel with the XLA conv it follows "
                         f"({JAX_INT8_CONV}); replaced_ms: im2col, "
                         f"torch._int_mm and P1's kernel; library_ms "
                         f"null: no PyTorch call computes an int8 conv")})
            del out, ref
        del q, w
    log(f"int8 conv kernels ok: bit-equal to the plain route at the "
        f"{len(INT8_CONV_SHAPES)} conv shapes of the int8 forward")
    return rows


# D1: every distinct shape of deformable_resnet50's deformable convs at
# batch N, 640x640: (input size, channels, stride); the conv's output
# channels equal its input's (planes). deformable_resnet18's six are the
# stride-1 ones.
DEFORM_SHAPES = ((SIZE // 4, 128, 2), (SIZE // 8, 128, 1),
                 (SIZE // 8, 256, 2), (SIZE // 16, 256, 1),
                 (SIZE // 16, 512, 2), (SIZE // 32, 512, 1))
DEFORM_ROW_SHAPE = (SIZE // 8, 128, 1)    # the rows: 4 of the 13 convs
# offsets, px: "random" leaves the map at many taps, "wide" at most
DEFORM_OFFSET_STD = {"zero": 0.0, "random": 3.0, "wide": 12.0}


def deform_inputs(h: int, c: int, stride: int, offsets: str):
    """f32 NHWC x (N, h, h, c) (a ReLU's output, as the blocks feed the
    conv) and f32 offsets, normal of DEFORM_OFFSET_STD[offsets] px (zero:
    every tap on an integer coordinate, as at init), on the card."""
    g = torch.Generator().manual_seed(SEED + h + c + stride)
    x = torch.relu(torch.randn((N, h, h, c), generator=g))
    oh = DF.out_size(h, stride)
    off = torch.zeros((N, oh, oh, 18))
    if DEFORM_OFFSET_STD[offsets]:
        off = torch.randn((N, oh, oh, 18), generator=g) * \
            DEFORM_OFFSET_STD[offsets]
    return x.cuda(), off.cuda()


def check_deform(x, off, stride, dtype, what):
    """D1 forward and backward against the plain halves on the same
    inputs: f32 columns bit-equal, bf16 ones within one bf16 ulp of the
    plain value; dx within 1e-5 and doffsets within 1e-4 of each one's
    largest (atomic order). Returns (cols err, cols tol, dx err, dx tol,
    doffsets err, doffsets tol) and the column gradient."""
    cols = DF.deform_im2col(x, off, stride, dtype)
    ref = DF.deform_im2col_plain(x, off, stride, dtype)
    diff = (cols.float() - ref.float()).abs()
    if dtype == torch.float32:
        tol = 0.0
        ok = torch.equal(cols, ref)
    else:
        tol = 2.0 ** -7 * ref.float().abs().max().item()
        ok = bool((diff <= ref.float().abs() * 2.0 ** -7).all())
    if not ok:
        raise AssertionError(f"{what}: columns differ by "
                             f"{diff.max().item()}")
    # laid out as deform_conv's backward hands it over: the (9, P, C) view
    # of a (P, 9, C) product
    g = torch.Generator(device="cuda").manual_seed(SEED)
    nine, p, c = cols.shape
    gcols = torch.randn((p, nine, c), generator=g, device="cuda").to(
        dtype).transpose(0, 1)
    dx, doff = DF.deform_col2im(x, off, gcols, stride)
    dx_p, doff_p = DF.deform_col2im_plain(x, off, gcols, stride)
    errs = [diff.max().item(), tol]
    for name, got, want, rel in (("dx", dx, dx_p, 1e-5),
                                 ("doffsets", doff, doff_p, 1e-4)):
        err = (got - want).abs().max().item()
        leaf_tol = rel * want.abs().max().item()
        if not (torch.isfinite(got).all() and err <= leaf_tol):
            raise AssertionError(f"{what}: {name} max_abs_err {err} > "
                                 f"{leaf_tol}")
        errs += [err, leaf_tol]
    return errs, gcols


def grid_sample_call(x, off, stride):
    """One ``F.grid_sample`` (bilinear, zeros, align_corners=True) that
    samples the same 9 taps: the input as NCHW, the grid (N, OH, 9·OW, 2)
    of the taps' coordinates normalised to [-1, 1]. Returns (input, grid),
    both requiring grad, and the call."""
    import torch.nn.functional as F

    n, h, w, _ = x.shape
    y, xs = DF._coords(off, stride)                    # (9, N, OH, OW)
    grid = torch.stack([xs / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1], -1)
    grid = grid.permute(1, 2, 0, 3, 4).reshape(n, y.shape[2], -1, 2)
    inp = x.permute(0, 3, 1, 2).detach().requires_grad_()
    grid = grid.contiguous().requires_grad_()

    def call():
        return F.grid_sample(inp, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    return inp, grid, call


def deform_bytes(h: int, c: int, stride: int, col_bytes: int,
                 backward: bool) -> int:
    """The least bytes D1 must move at a shape: the f32 input read once,
    the offsets read, the columns written (forward); or the column
    gradient read and dx and doffsets written besides (backward)."""
    oh = DF.out_size(h, stride)
    x_b, off_b = N * h * h * c * 4, N * oh * oh * 18 * 4
    cols_b = 9 * N * oh * oh * c * col_bytes
    if not backward:
        return x_b + off_b + cols_b
    return cols_b + x_b + off_b + x_b + off_b


def deform_conv_bound(h: int, c: int, stride: int, backward: bool
                      ) -> tuple[float, str]:
    """The whole bf16 deformable conv's bound (F = C), the target of a
    fused design: its FLOPs at the bf16 peak against the input, offsets
    and output bytes (the backward: twice the FLOPs, dgrad and wgrad;
    the output's gradient read, dx, doffsets and the kernel's gradient
    written)."""
    oh = DF.out_size(h, stride)
    p = N * oh * oh
    flops = 2 * p * 9 * c * c * (2 if backward else 1)
    x_b, off_b, out_b = N * h * h * c * 4, p * 18 * 4, p * c * 2
    moved = x_b + off_b + out_b + ((x_b + off_b + 9 * c * c * 4)
                                   if backward else 0)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_deform_kernels() -> list[dict]:
    """D1 forward (deform_im2col) and backward (deform_col2im) against
    their plain halves on the card at each distinct deformable conv shape
    of deformable_resnet50 (batch 8, 640x640), in both compute dtypes, at
    zero and at random offsets of std 3 and 12 px (check_deform); each
    case timed cold (events after the L2 flush, and the profiler's device
    time) against its bound; the rows at DEFORM_ROW_SHAPE in bf16 at std
    3 px with device ms, plain ms, the whole conv's bound and one
    F.grid_sample call (its backward for the backward row) as the
    library's time."""
    rows, shapes = [], []
    for h, c, stride in DEFORM_SHAPES:
        for offsets in DEFORM_OFFSET_STD:
            x, off = deform_inputs(h, c, stride, offsets)
            if offsets != "zero":
                ys = (torch.arange(off.shape[1], device="cuda") * stride)[
                    None, :, None, None] + off[..., 0::2]
                if not ((ys < -1).any() and (ys > h).any()):
                    raise AssertionError("D1: no tap leaves the map")
            for dtype in (torch.bfloat16, torch.float32):
                what = (f"D1 {N}x{h}x{h}x{c} stride {stride} {offsets} "
                        f"offsets {str(dtype)[6:]}")
                errs, gcols = check_deform(x, off, stride, dtype, what)

                def fwd():
                    return DF.deform_im2col(x, off, stride, dtype)

                def bwd():
                    return DF.deform_col2im(x, off, gcols, stride)

                ms_f, ms_b = timed(fwd, 10), timed(bwd, 10)
                cb = 2 if dtype == torch.bfloat16 else 4
                bf = deform_bytes(h, c, stride, cb, False)
                bb = deform_bytes(h, c, stride, cb, True)
                shapes.append({
                    "shape": [N, h, h, c], "stride": stride,
                    "dtype": str(dtype)[6:], "offset_std_px":
                    DEFORM_OFFSET_STD[offsets], "errs": errs,
                    "im2col_ms": ms_f,
                    "im2col_device_ms": device_kernels(fwd, 10)[0],
                    "col2im_device_ms": device_kernels(bwd, 10)[0],
                    "im2col_bound_ms": bf / HBM_BYTES_PER_S * 1e3,
                    "col2im_ms": ms_b,
                    "col2im_bound_ms": bb / HBM_BYTES_PER_S * 1e3})
                if (h, c, stride) == DEFORM_ROW_SHAPE \
                        and dtype == torch.bfloat16 and offsets == "random":
                    rows += deform_rows(x, off, stride, dtype, gcols, errs)
                del gcols
            del x, off
            torch.cuda.empty_cache()
    log(f"D1 shapes (cold, ms by CUDA events after the L2 flush; bound = "
        f"bytes / 3.35 TB/s): {json.dumps(shapes)}")
    log(f"D1 kernels ok: forward and backward held to their plain halves "
        f"at {len(DEFORM_SHAPES)} shapes x 2 dtypes x offsets of std "
        f"{list(DEFORM_OFFSET_STD.values())} px")
    return rows


def deform_rows(x, off, stride, dtype, gcols, errs) -> list[dict]:
    """The D1 rows of the kernels line at one shape: kernel_row's times
    and bound, the whole conv's bound, and F.grid_sample's forward (the
    forward row) or backward (the backward row) as library_ms."""
    n, h, _, c = x.shape
    cb = 2 if dtype == torch.bfloat16 else 4
    _, oh, ow, _ = off.shape
    elems = 9 * n * oh * ow * c
    inp, grid, call = grid_sample_call(x, off, stride)
    out = call()
    ref = DF.deform_im2col_plain(x, off, stride, torch.float32)
    lib_gap = (out.permute(0, 2, 3, 1).reshape(n, oh, 9, ow, c).permute(
        2, 0, 1, 3, 4).reshape(9, -1, c) - ref).abs().max().item()
    gout = torch.randn_like(out)
    rows = []
    for name, err, tol, kernel, plain, backward, library, ops in (
            ("deform_im2col", errs[0], errs[1],
             lambda: DF.deform_im2col(x, off, stride, dtype),
             lambda: DF.deform_im2col_plain(x, off, stride, dtype), False,
             call, 9),
            ("deform_col2im", errs[2], errs[3],
             lambda: DF.deform_col2im(x, off, gcols, stride),
             lambda: DF.deform_col2im_plain(x, off, gcols, stride), True,
             lambda: torch.autograd.grad(out, (inp, grid), gout,
                                         retain_graph=True), 21)):
        row = kernel_row(name, "cuda", DEFORM_SRC, f"{JAX_DEFORM}:24", err,
                         tol, kernel, plain,
                         deform_bytes(h, c, stride, cb, backward),
                         elems * ops)
        row["library_ms"] = timed(library, 10)
        row["conv_bound_ms"], row["conv_bound_by"] = deform_conv_bound(
            h, c, stride, backward)
        row["shape"] = [n, h, h, c]
        row["stride"] = stride
        row["dtype"] = str(dtype)[6:]
        row["note"] = (
            "library_ms: F.grid_sample over the 9-tap grid "
            + ("(its backward)" if backward else "(f32 samples, no cast)")
            + f", max abs {lib_gap:.3g} from the plain f32 columns")
        if backward:
            row["max_abs_err_of"] = "dx"
            row["doffsets_max_abs_err"], row["doffsets_tol"] = errs[4:6]
        rows.append(row)
    return rows


def synthetic_images() -> list[bytes]:
    from PIL import Image

    rng = np.random.RandomState(SEED)
    out = []
    for _ in range(N):
        img = (rng.rand(480, 640, 3) * 60).astype(np.uint8)
        for _ in range(5):
            y, x = rng.randint(0, 420), rng.randint(0, 500)
            img[y:y + rng.randint(15, 60), x:x + rng.randint(40, 140)] = \
                rng.randint(150, 255)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        out.append(buf.getvalue())
    return out


def serve_stages(handler: DBTextDetectionHandler, request: list,
                 reps: int = 11) -> dict:
    """Box mode's stages per batch, ``reps`` times: host preprocess, the
    forward box mode runs (the folded modes' prob-only one) to a
    synchronisation, and the box postprocess. Host stages vary from call
    to call on a shared host, so the result is ms [q25, median, q75] of the
    per-batch times."""
    stages = {"preprocess": [], "forward": [], "postprocess_boxes": [],
              "total": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch = handler.preprocess(request)
        t1 = time.perf_counter()
        preds = handler.inference(batch, prob_only=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        handler.postprocess_boxes(preds)
        t3 = time.perf_counter()
        for name, dt in (("preprocess", t1 - t0), ("forward", t2 - t1),
                         ("postprocess_boxes", t3 - t2), ("total", t3 - t0)):
            stages[name].append(dt * 1e3)
    return {k: [float(q) for q in np.percentile(v, [25, 50, 75])]
            for k, v in stages.items()}


def check_box_result(result: list) -> None:
    if len(result) != N:
        raise AssertionError(f"{len(result)} results for {N} images")
    for r in result:
        boxes = np.asarray(r["boxes"], float).reshape(-1, 4, 2)
        if len(boxes) != len(r["scores"]) or not np.isfinite(boxes).all():
            raise AssertionError(f"malformed box result {r}")


def phase_serve(workdir: str) -> tuple[dict, str, torch.Tensor, float]:
    model = DBTextModel()
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    pth = os.path.join(workdir, "dbnet_resnet18_seed.pth")
    torch.save(model.state_dict(), pth)
    # the plain fused-head module, bf16 on the card (the default)
    handler = DBTextDetectionHandler(pth, infer_mode="flax")
    handler.initialize()
    request = [{"body": b} for b in synthetic_images()]

    cc.reset_launches()
    result = handler.handle(request, mode="boxes")
    torch.cuda.synchronize()
    launches = dict(cc.LAUNCHES)
    check_launches(launches, RECT_PATH, "serve, box mode")
    check_box_result(result)
    log(f"serve ok: batch of {N} in box mode, boxes per image "
        f"{[len(r['boxes']) for r in result]}, launches {launches}")

    # the fp32 parity configuration beside it (TF32 off), timed in turns
    fp32 = DBTextDetectionHandler(pth, infer_mode="flax",
                                  dtype=torch.float32)
    fp32.initialize()
    batch = handler.preprocess(request)
    preds, preds32 = handler.inference(batch), fp32.inference(batch)
    gap = (preds - preds32).abs().mean().item()
    if not (preds.dtype == torch.float32 and 0 < gap < 0.02):
        raise AssertionError(f"flax bf16 maps ({preds.dtype}) vs fp32: mean "
                             f"abs {gap}")
    timing = {}
    for name, h in (("bf16", handler), ("fp32", fp32), ("bf16", handler),
                    ("fp32", fp32)):
        timing[name] = serve_stages(h, request, reps=6)
    for name, quartiles in timing.items():
        log(f"serve timing ({name}): {N * 1e3 / quartiles['total'][1]:.2f} "
            f"img/s at batch {N}, flax mode, {name}, 640x640 (median of 6 "
            f"batches, the later of two turns); forward median "
            f"{quartiles['forward'][1]:.3f} ms; per batch ms [q25, median, "
            f"q75] {json.dumps(quartiles)}")
    log(f"serve ok: flax bf16 maps against fp32 maps, mean abs {gap:.3g} "
        f"(bound 0.02)")
    return launches, pth, preds, timing["bf16"]["forward"][1]


def int8_conv_work(fn) -> tuple[int, int]:
    """The bytes and int8 operations the int8 convs must move and do in
    one call of ``fn``: each conv's int8 input and weights read once, its
    output written once, its scales and biases read once, and 2 M N K
    operations (the op is wrapped for this call only; its launches still
    count)."""
    work = []
    real = Q.int8_conv

    def counting(q, w_cols, k, stride, pad, scale, bias, relu,
                 out_scale=None):
        out = real(q, w_cols, k, stride, pad, scale, bias, relu, out_scale)
        kk = k * k * q.shape[3]
        work.append((q.numel() + out.shape[-1] * kk
                     + out.numel() * out.element_size() + scale.numel() * 8,
                     2 * out.numel() * kk))
        return out

    Q.int8_conv = counting
    try:
        fn()
    finally:
        Q.int8_conv = real
    return sum(w[0] for w in work), sum(w[1] for w in work)


def host_ops(fn) -> set:
    """The names of the ATen operators ``fn`` calls (torch.profiler's CPU
    events): the int8 forward must call no ``aten::_int_mm`` and no
    ``aten::unfold`` (im2col)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()}


def phase_quant(pth: str, flax_forward_ms: float) -> dict:
    """The folded modes on the served .pth and batch. The handler in
    "folded" mode (the default; the int8 conv never launches) and in "int8"
    mode (dynamic scales, skip=(): the int8 conv's kernel 17 times a
    forward, all in the f32 form), each in box mode and in masks mode; then
    make_folded_forward with static scales calibrated on the batch's first
    2 images (7 int8-form and 10 f32-form launches), in box mode through
    the handler's postprocess. P1's own kernel never launches. The counts
    are set to 0 before each forward and read after it; the int8 conv rows'
    launches are their sum. Then box mode's stage timing for each, and each
    forward profiled: no ``torch._int_mm`` and no im2col remain."""
    request = [{"body": b} for b in synthetic_images()]
    i8_total = {k: 0 for k in I8.LAUNCHES}
    maps = {}
    handlers = {}

    def drive(what, fn, want_int8, want_f32, rect_path):
        cc.reset_launches()
        I8.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        i8 = dict(I8.LAUNCHES)
        if (i8["int8_conv_int8"], i8["int8_conv_f32"],
                i8["int8_epilogue"]) != (want_int8, want_f32, 0):
            raise AssertionError(f"{what}: int8 launches {i8}, want "
                                 f"{want_int8} int8-form and {want_f32} "
                                 f"f32-form int8 convs, no P1")
        if rect_path:
            check_launches(dict(cc.LAUNCHES), RECT_PATH, what)
        for k in i8_total:
            i8_total[k] += i8[k]
        return out, i8

    for mode in ("folded", "int8"):
        handler = DBTextDetectionHandler(pth, infer_mode=mode)
        handler.initialize()
        handlers[mode] = handler
        f32_form = INT8_CONVS if mode == "int8" else 0
        result, i8 = drive(f"quant serve {mode}, box mode",
                           lambda: handler.handle(request, mode="boxes"),
                           0, f32_form, True)
        check_box_result(result)
        maps[mode], _ = drive(
            f"quant serve {mode}, masks forward",
            lambda: handler.inference(handler.preprocess(request)), 0,
            f32_form, False)
        log(f"quant serve ok ({mode}): batch of {N} in box mode, boxes per "
            f"image {[len(r['boxes']) for r in result]}, int8 launches a "
            f"forward {i8}")

    # the served batch as the folded forwards take it: f32 on the card,
    # the Caffe means subtracted (the handlers' own step)
    batch = torch.from_numpy(handlers["int8"].preprocess(request)).cuda()
    batch = batch.float() - torch.tensor(CAFFE_MEAN, device=batch.device)
    static = make_folded_forward(load_state_dict(pth, fuse_head=True),
                                 quantize=True, calibration=[batch[:2]])
    int8_handler = handlers["int8"]
    result, i8 = drive(
        "quant static, box mode",
        lambda: int8_handler.postprocess_boxes(static(batch, prob_only=True)),
        FUSED_PLACES, INT8_CONVS - FUSED_PLACES, True)
    check_box_result(result)
    maps["int8_static"], _ = drive("quant static, both maps",
                                   lambda: static(batch), FUSED_PLACES,
                                   INT8_CONVS - FUSED_PLACES, False)
    log(f"quant static ok: calibrated on 2 images, {INT8_CONVS} int8 convs, "
        f"boxes per image {[len(r['boxes']) for r in result]}, int8 "
        f"launches a forward {i8}")

    for mode, handler in handlers.items():
        quartiles = serve_stages(handler, request)
        log(f"quant serve timing ({mode}): "
            f"{N * 1e3 / quartiles['total'][1]:.2f} img/s at batch {N}, "
            f"640x640, float convs bf16 (median of 11 batches); forward "
            f"median {quartiles['forward'][1]:.3f} ms against the flax "
            f"mode's {flax_forward_ms:.3f} ms (bf16); per batch ms [q25, "
            f"median, q75] {json.dumps(quartiles)}")
    # where a box-mode forward's time goes on the card, in each mode
    batch_u8 = handlers["int8"].preprocess(request)
    for mode, fn in (
            ("folded", lambda: handlers["folded"].inference(
                batch_u8, prob_only=True)),
            ("int8", lambda: handlers["int8"].inference(batch_u8,
                                                        prob_only=True)),
            ("int8 static", lambda: static(batch, prob_only=True))):
        fwd_ms = []
        for _ in range(11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        q25, med, q75 = (float(q) for q in np.percentile(fwd_ms,
                                                         [25, 50, 75]))
        busy_ms, by_name, _ = device_kernels(fn, 3)
        conv_ms = sum(v for k, v in by_name.items()
                      if "int8_conv_kernel" in k)
        conv_bound, conv_by = bound(*int8_conv_work(fn), INT8_OPS_PER_S)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        if mode != "folded":
            left = {"aten::_int_mm", "aten::unfold"} & host_ops(fn)
            if left or any("epilogue<" in k for k in by_name):
                raise AssertionError(f"quant profile ({mode}): the old "
                                     f"route is still there: {left}, "
                                     f"{sorted(by_name)}")
        log(f"quant profile ({mode}): prob-only forward ms [q25, median, "
            f"q75] [{q25:.3f}, {med:.3f}, {q75:.3f}]; the card busy "
            f"{busy_ms:.3f} ms a forward (idle "
            f"{100 * (1 - busy_ms / med):.2f} %), the int8 convs "
            f"{conv_ms:.4f} ms of it against their bound {conv_bound:.4f} "
            f"ms ({conv_by}); no _int_mm, unfold or P1 kernel; top "
            f"kernels ms "
            f"{json.dumps({k[:60]: round(v, 4) for k, v in top})}")
    return {"launches": i8_total, "maps": maps, "static": static,
            "batch": batch}


def event_median(fn, reps: int = 11) -> float:
    """Median ms of ``fn`` by CUDA events around each call, after two
    warm-up calls (no L2 flush: whole forwards)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_export_maps(what: str, got: torch.Tensor, ref: torch.Tensor
                      ) -> float:
    """At most EXPORT_SHARE of the pixels more than EXPORT_TOL apart;
    returns the max difference."""
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against "
                             f"{tuple(ref.shape)}")
    diff = (got.float() - ref.float()).abs()
    share = (diff > EXPORT_TOL).float().mean().item()
    if not (torch.isfinite(got).all() and share <= EXPORT_SHARE):
        raise AssertionError(f"{what}: {share:.4%} of pixels more than "
                             f"{EXPORT_TOL} apart (max {diff.max().item()})")
    return diff.max().item()


def check_same_boxes(what: str, got: list, ref: list) -> float:
    """The same number of boxes per image, each box within 2.5 px (every
    corner) of one of the other's; returns the largest such gap."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        gb = np.asarray(g["boxes"], float).reshape(-1, 4, 2)
        rb = np.asarray(r["boxes"], float).reshape(-1, 4, 2)
        if len(gb) != len(rb):
            raise AssertionError(f"{what}: image {i}: {len(gb)} boxes "
                                 f"against {len(rb)}")
        for box in gb:
            gap = np.abs(rb - box).max(axis=(1, 2)).min()
            if gap >= 2.5:
                raise AssertionError(f"{what}: image {i}: a box {gap} px "
                                     f"from the nearest live box")
            worst = max(worst, float(gap))
    return worst


def drive_export(what: str, infer, live, batch_u8: np.ndarray,
                 want_i8: int, int8: bool = False, want_d1: int = 0) -> dict:
    """One archive: batch 1 and batch N from it against the live forward
    of the same mode on the same uint8 batch, the int8 conv's and D1's
    launches in one forward of N (counts set to 0 just before, read just after), and both
    forwards timed. The graph takes 2 or more images, so batch 1 runs as
    its image twice: it is held to the live forward of that pair by the
    export rule, and to the live batch of 1, whose convs take other
    algorithms, by the export rule, or for int8 (where a float flip moves
    a whole int8 step) by the int8 rule (a mean within 0.02, JAX
    test_pallas_ops.py:315-320)."""
    x = torch.from_numpy(batch_u8).cuda()
    one, full = infer(batch_u8[:1]), infer(batch_u8)
    gapn = check_export_maps(f"{what}, batch {N}", full, live(x))
    gap1 = check_export_maps(f"{what}, batch 1 against the live pair",
                             one, live(x[:1].repeat(2, 1, 1, 1))[:1])
    alone = live(x[:1])
    diff = (one - alone).abs()
    share = (diff > EXPORT_TOL).float().mean().item()
    if int8:
        if not diff.mean().item() < 0.02:
            raise AssertionError(f"{what}, batch 1: mean {diff.mean()} from "
                                 f"the live batch of 1")
    else:
        check_export_maps(f"{what}, batch 1", one, alone)
    I8.reset_launches()
    DF.reset_launches()
    infer(x)
    torch.cuda.synchronize()
    i8, d1 = dict(I8.LAUNCHES), dict(DF.LAUNCHES)
    if i8["int8_conv"] != want_i8 or i8["int8_epilogue"]:
        raise AssertionError(f"{what}: the int8 kernels launched {i8} in "
                             f"one forward, want {want_i8} int8 convs")
    if d1 != {"deform_im2col": want_d1, "deform_col2im": 0}:
        raise AssertionError(f"{what}: D1 launched {d1} in one forward, "
                             f"want {want_d1} forward launches")
    ms, live_ms = event_median(lambda: infer(x)), event_median(
        lambda: live(x))
    log(f"export ok ({what}): one archive served batch 1 and {N} "
        f"({tuple(full.shape)}, meta {json.dumps(infer.meta)}); max "
        f"difference from the live forward {gapn:.3g} at batch {N}, "
        f"{gap1:.3g} at batch 1 (against the live pair); against the live "
        f"batch of 1: max {diff.max().item():.3g}, mean "
        f"{diff.mean().item():.3g}, {share:.4%} of pixels beyond "
        f"{EXPORT_TOL}; int8 launches a forward {i8}, D1 {d1}; forward at "
        f"batch {N} "
        f"{ms:.3f} ms against the live {live_ms:.3f} ms (median of 11, CUDA "
        f"events)")
    return {"ms": ms, "live_ms": live_ms, "i8": i8, "d1": d1}


def live_forward(pth: str, mode: str, prob_only: bool):
    """The live forward of a mode on uint8 batches, as the handler runs
    it: the means subtracted on the card, then the fused-head module (bf16)
    or the folded forward."""
    mean = torch.tensor(CAFFE_MEAN, device="cuda")
    if mode == "flax":
        model = load_model(pth, fuse_head=True)

        def fwd(x):
            with torch.inference_mode():
                y = model(x.float() - mean)
            return y[..., :1] if prob_only else y
        return fwd
    folded = make_folded_forward(load_state_dict(pth, fuse_head=True),
                                 quantize=mode == "int8",
                                 prob_only=prob_only)
    return lambda x: folded(x.float() - mean)


def phase_export(workdir: str, pth: str) -> dict:
    """``serve.export`` at full width on the served .pth: the flax (bf16,
    both maps), folded and int8 (prob-only) archives with a symbolic batch
    and uint8 input, each loaded back, held to the live forward of its
    mode at batch 1 and N (EXPORT_TOL, EXPORT_SHARE) and timed; the int8
    archive launches the int8 conv's kernel INT8_CONVS times a forward
    through the custom op. Then the folded and int8 archives serve the
    batch through the handler in box mode: K3-K6 launch, the int8 conv
    INT8_CONVS times for int8, and the folded archive's boxes are the live
    folded handler's within 2.5 px."""
    request = [{"body": b} for b in synthetic_images()]
    live_handler = DBTextDetectionHandler(pth, infer_mode="folded")
    batch_u8 = live_handler.preprocess(request)
    rows, paths = {}, {}
    for mode, prob_only in (("flax", False), ("folded", True),
                            ("int8", True)):
        t0 = time.perf_counter()
        source = (load_model(pth, fuse_head=True) if mode == "flax"
                  else load_state_dict(pth, fuse_head=True))
        paths[mode] = export_model(
            source, os.path.join(workdir, f"db_{mode}.pt2"),
            input_shape=(None, SIZE, SIZE, 3), infer_mode=mode,
            prob_only=prob_only)
        export_s = time.perf_counter() - t0
        infer = load_exported(paths[mode])
        rows[mode] = drive_export(
            f"{mode} archive", infer, live_forward(pth, mode, prob_only),
            batch_u8, INT8_CONVS if mode == "int8" else 0,
            int8=mode == "int8")
        rows[mode]["export_s"] = export_s
        log(f"export timing ({mode}): export and save "
            f"{export_s:.2f} s, {os.path.getsize(paths[mode])} bytes")

    live = live_handler.handle(request, mode="boxes")
    for mode in ("folded", "int8"):
        handler = DBTextDetectionHandler(paths[mode])
        handler.initialize()
        cc.reset_launches()
        I8.reset_launches()
        result = handler.handle(request, mode="boxes")
        torch.cuda.synchronize()
        launches = {**cc.LAUNCHES, **I8.LAUNCHES}
        check_launches(launches, RECT_PATH, f"the {mode} archive served")
        want = INT8_CONVS if mode == "int8" else 0
        if launches["int8_conv"] != want or launches["int8_epilogue"]:
            raise AssertionError(f"the {mode} archive served: int8 conv "
                                 f"launches {launches['int8_conv']}, want "
                                 f"{want}")
        check_box_result(result)
        gap = (check_same_boxes(f"the {mode} archive served", result, live)
               if mode == "folded" else None)
        try:
            handler.handle(request[:1], mode="masks")
            raise AssertionError("a prob-only archive served masks mode")
        except ValueError as e:
            if "prob_only" not in str(e):
                raise
        quartiles = serve_stages(handler, request)
        log(f"export serve ok ({mode}): handle() in box mode from "
            f"{os.path.basename(paths[mode])}, boxes per image "
            f"{[len(r['boxes']) for r in result]}, largest gap to the live "
            f"folded handler's boxes {gap} px; masks mode refused; "
            f"launches {json.dumps(launches)}; "
            f"{N * 1e3 / quartiles['total'][1]:.2f} img/s, per batch ms "
            f"[q25, median, q75] {json.dumps(quartiles)}")
    return rows


def prune_pth(workdir: str, pth: str, name: str, keeps: tuple) -> tuple:
    out = os.path.join(workdir, f"{name}.pth")
    t0 = time.perf_counter()
    report = prune_cli.main(prune_cli.load_args(
        ["--checkpoint", pth, "--out", out, "--backbone_keep", keeps[0],
         "--fpn_inner_keep", keeps[1], "--fpn_out_keep", keeps[2]]))
    if load_widths(out) != report["widths"]:
        raise AssertionError(f"{name}: the sidecar does not hold the widths")
    log(f"prune ok ({name}): keeps {keeps}, widths "
        f"{json.dumps(report['widths'])}, params {report['params']}, conv "
        f"weight MACs ratio {report['conv_weight_macs']['ratio']}, in "
        f"{time.perf_counter() - t0:.2f} s")
    return out, report


def phase_prune(workdir: str, pth: str) -> dict:
    """``cli.prune`` on the served .pth at the JAX p50 keeps (the widths
    and param ratio of the JAX report) and at odd keeps (K and N of the
    int8 GEMMs padded); each loaded by ``load_model`` and
    ``build_inference_forward`` with its sidecar: the folded forward in fp32
    against the pruned model in fp32 (atol 2e-4, JAX test_prune.py:186) on
    2 images; the folded and int8 handlers in box mode (K3-K6, and the int8
    conv's kernel once per int8 conv); 3 bf16 train steps of the p50 model at batch 4 (K2
    each step) whose checkpoints carry the sidecar; the odd-keep int8
    archive held as in the export phase; the folded forward at batch N,
    full against p50, timed in turns."""
    request = [{"body": b} for b in synthetic_images()]
    p50, report = prune_pth(workdir, pth, "p50", P50_KEEPS)
    if (report["widths"] != P50_WIDTHS
            or report["params"]["ratio"] != P50_PARAM_RATIO):
        raise AssertionError(f"p50: {report} against the JAX report's "
                             f"{P50_WIDTHS}, {P50_PARAM_RATIO}")
    odd, _ = prune_pth(workdir, pth, "odd", ODD_KEEPS)
    batch_u8 = DBTextDetectionHandler(pth).preprocess(request)
    x = (torch.from_numpy(batch_u8[:2]).cuda().float()
         - torch.tensor(CAFFE_MEAN, device="cuda"))
    handlers, gaps = {}, {}
    crop = x[:, 288:352, 288:352].contiguous()
    for name, path in (("full", pth), ("p50", p50), ("odd", odd)):
        # the folded forward in fp32 against the model in fp32, on 2 crops
        # of 64x64 (the JAX test's size) and on the 2 images, held to the
        # JAX export tests' rule for the same maps up to summation order;
        # the full model's gaps are the yardstick
        model = load_model(path, dtype=torch.float32)
        qv, _ = build_inference_forward(path, infer_mode="folded")
        with torch.inference_mode():
            gaps[name] = [check_export_maps(
                f"{name}: folded fp32 against the model at {what}",
                Q.quant_dbnet_forward(qv, t, compute_dtype=torch.float32),
                model(t)) for what, t in (("64x64", crop),
                                          ("640x640", x))]
        if name == "full":
            continue
        int8_qv, _ = build_inference_forward(path, infer_mode="int8")
        n_int8 = len(Q._forward_conv_order(int8_qv["params"]))
        padded = sorted(
            f"{blk}/{conv}" for blk, node in int8_qv["params"][
                "backbone"].items() if "conv1" in node
            for conv, leaf in node.items() if "w_cols" in leaf)
        for mode in ("folded", "int8"):
            handler = DBTextDetectionHandler(path, infer_mode=mode)
            handler.initialize()
            cc.reset_launches()
            I8.reset_launches()
            result = handler.handle(request, mode="boxes")
            torch.cuda.synchronize()
            launches = {**cc.LAUNCHES, **I8.LAUNCHES}
            check_launches(launches, RECT_PATH, f"{name} {mode} served")
            want = n_int8 if mode == "int8" else 0
            if launches["int8_conv"] != want or launches["int8_epilogue"]:
                raise AssertionError(f"{name} {mode}: int8 conv launches "
                                     f"{launches['int8_conv']}, want "
                                     f"{want}")
            check_box_result(result)
            handlers[(name, mode)] = handler
            log(f"prune serve ok ({name}, {mode}): box mode, boxes per "
                f"image {[len(r['boxes']) for r in result]}, launches "
                f"{json.dumps(launches)}")
        log(f"prune check ok ({name}): folded fp32 against the pruned "
            f"model fp32, max {gaps[name][0]:.3g} on 2 crops of 64x64, "
            f"{gaps[name][1]:.3g} on 2 images of 640x640 (the full model: "
            f"{gaps['full'][0]:.3g}, {gaps['full'][1]:.3g}; at most "
            f"{EXPORT_SHARE:.0%} of pixels beyond {EXPORT_TOL}); {n_int8} "
            f"int8 convs, padded GEMMs in the backbone {padded}")

    # three bf16 train steps of the p50 model, its checkpoints' sidecars
    cfg = train_config(os.path.join(workdir, "p50_train"), SIZE,
                       TRAIN_BATCH, "cuda")
    cfg.model.widths = load_widths(p50)
    cfg.metric.is_output_polygon = False
    batch = text_batch(SEED, TRAIN_BATCH, SIZE)
    trainer = T.Trainer(cfg, [batch] * PRUNE_STEPS,
                        [text_batch(SEED + 1, 1, SIZE)])
    state = trainer.resume_state(p50)
    D.reset_launches()
    state, history = trainer.fit(state, no_epochs=1)
    torch.cuda.synchronize()
    k2 = dict(D.LAUNCHES)
    if not (k2["db_step_forward"] == k2["db_step_backward"] == PRUNE_STEPS):
        raise AssertionError(f"p50 train: K2 launches {k2}")
    last = os.path.join(cfg.meta.root_dir, cfg.model.last_cp_path)
    if load_widths(last) != P50_WIDTHS:
        raise AssertionError(f"p50 train: {last} has no widths sidecar")
    losses = [row["total_loss"] for row in trainer.loss_log]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"p50 train: losses {losses}")
    log(f"prune train ok: {PRUNE_STEPS} bf16 steps of the p50 model at "
        f"batch {TRAIN_BATCH}, losses {[round(v, 4) for v in losses]}, K2 "
        f"launches {k2}, {os.path.basename(last)} with its sidecar")

    # the odd-keep int8 archive, padded GEMMs and all
    infer = load_exported(export_model(
        load_state_dict(odd, fuse_head=True),
        os.path.join(workdir, "odd_int8.pt2"),
        input_shape=(None, SIZE, SIZE, 3), infer_mode="int8",
        prob_only=True, widths=load_widths(odd)))
    odd_qv, _ = build_inference_forward(odd, infer_mode="int8")
    drive_export("odd-keep int8 archive", infer,
                 live_forward(odd, "int8", True), batch_u8,
                 len(Q._forward_conv_order(odd_qv["params"])), int8=True)

    # the folded forward at batch N, full against p50, in turns
    full = DBTextDetectionHandler(pth, infer_mode="folded")
    full.initialize()
    times = {}
    for name, handler in (("full", full), ("p50", handlers[("p50",
                                                            "folded")]),
                          ("full", full), ("p50", handlers[("p50",
                                                            "folded")])):
        times[name] = event_median(
            lambda: handler.inference(batch_u8, prob_only=True))
        times[name + " handle"] = serve_stages(handler, request, reps=6)
    log(f"prune timing: the folded prob-only forward at batch {N}, "
        f"640x640, bf16 convs: full {times['full']:.3f} ms, p50 "
        f"{times['p50']:.3f} ms ({times['full'] / times['p50']:.3f}x; "
        f"median of 11, the later of two turns); handle() in box mode: full "
        f"{N * 1e3 / times['full handle']['total'][1]:.2f} img/s, p50 "
        f"{N * 1e3 / times['p50 handle']['total'][1]:.2f} img/s; per batch "
        f"ms full {json.dumps(times['full handle'])}, p50 "
        f"{json.dumps(times['p50 handle'])}")
    return times


def phase_check_quant(flax_preds: torch.Tensor, quant: dict) -> None:
    """The folded and int8 prob maps against the flax mode's on the served
    batch (mean abs < 0.02, the JAX package's bound for int8 against
    float); the calibrated forward's fused and unfused forms bit-equal at
    batch 8; and that forward on the card against the CPU on 2 crops of
    256x256, float convs in f64 (every int8 activation equal, maps within
    1e-6) and in f32 (the first int8 conv's input equal at >= 99.9 % of
    positions and the maps within a mean of 0.05: random weights carry a
    single flip on to many later positions; the share of all int8
    activations that agree is reported)."""
    for mode, maps in quant["maps"].items():
        gap = (maps[..., 0] - flax_preds[..., 0]).abs()
        if not gap.mean().item() < 0.02:
            raise AssertionError(f"{mode} prob maps {gap.mean().item()} "
                                 f"from the flax mode's")
        log(f"check ok: {mode} prob maps against the flax mode's: mean abs "
            f"{gap.mean().item():.5f}, max {gap.max().item():.5f} "
            f"(tolerance: mean 0.02)")
    static, batch = quant["static"], quant["batch"]
    qv = static.qvars
    with torch.inference_mode():
        fused = Q.quant_dbnet_forward(qv, batch)
        plain = Q.quant_dbnet_forward(qv, batch, fuse=False)
    if not torch.equal(fused, plain):
        raise AssertionError("fused and unfused static forwards differ")
    log(f"check ok: the static int8 forward's fused and unfused forms are "
        f"bit-equal on the card at {N}x{SIZE}x{SIZE}")
    x = batch[:2, 128:384, 128:384].contiguous()
    cpu_tree = Q.tree_to(qv, "cpu")
    tolerance = {"f64": "all equal, maps max 1e-6",
                 "f32": "first int8 conv 99.9 %, maps mean 0.05"}
    for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        runs = []
        for tree, xx in ((qv, x), (cpu_tree, x.cpu())):
            inputs = []
            with torch.inference_mode():
                out = Q.quant_dbnet_forward(tree, xx, compute_dtype=dtype,
                                            int8_inputs=inputs)
            runs.append((out.cpu(), [q.cpu() for q in inputs]))
        (card, card_q), (cpu, cpu_q) = runs
        equal = sum(int((a == b).sum()) for a, b in zip(card_q, cpu_q))
        total = sum(a.numel() for a in cpu_q)
        first = (card_q[0] == cpu_q[0]).double().mean().item()
        gap = (card - cpu).abs()
        share = equal / total
        ok = (equal == total and gap.max().item() <= 1e-6 if name == "f64"
              else first >= 0.999 and gap.mean().item() < 0.05)
        if not ok:
            raise AssertionError(f"int8 forward, float convs {name}, card "
                                 f"vs CPU: {share} of int8 activations "
                                 f"equal ({first} at the first conv), maps "
                                 f"max {gap.max().item()}, mean "
                                 f"{gap.mean().item()}")
        log(f"check ok: static int8 forward on the card vs the CPU, float "
            f"convs {name}, 2x256x256: int8 activations equal at {equal} of "
            f"{total} positions ({100 * share:.4f} %; first int8 conv "
            f"{100 * first:.4f} %), maps max abs {gap.max().item():.3g}, "
            f"mean {gap.mean().item():.3g} (tolerance: {tolerance[name]})")


def poly_stages(rep: DevicePolyRepresenter, pred: torch.Tensor,
                reps: int = 11) -> tuple[dict, int]:
    """DevicePolyRepresenter on (N, H, W) maps on the card, in its three
    stages, ``reps`` times after a warm-up: the device half (CUDA events),
    the copy of its outputs to the host, and the host finishing (host
    clock). Returns ms [q25, median, q75] per stage and the bytes copied."""
    shape = {"shape": [tuple(pred.shape[1:])] * pred.shape[0]}
    rep(shape, pred)
    stages = {"device": [], "d2h": [], "host": [], "total": []}
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        stats = cc.device_poly_stats(pred, rep.thresh, rep.max_candidates)
        end.record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = [t.cpu().numpy() for t in stats]
        t2 = time.perf_counter()
        rep.finish(shape, pred.shape[2], *host)
        t3 = time.perf_counter()
        for name, ms in (("device", start.elapsed_time(end)),
                         ("d2h", (t2 - t1) * 1e3), ("host", (t3 - t2) * 1e3),
                         ("total", (t3 - t0) * 1e3)):
            stages[name].append(ms)
    quartiles = {k: [float(q) for q in np.percentile(v, [25, 50, 75])]
                 for k, v in stages.items()}
    return quartiles, sum(a.nbytes for a in host)


def phase_polygon(preds: torch.Tensor) -> dict:
    """Polygon mode on the served batch's maps (the handler's thresholds,
    0.3 and 0.7), then the stage times there and on the kernel scenes."""
    rep = DevicePolyRepresenter()
    shape = {"shape": [(SIZE, SIZE)] * N}
    cc.reset_launches()
    boxes, scores = rep(shape, preds)
    torch.cuda.synchronize()
    launches = dict(cc.LAUNCHES)
    check_launches(launches, POLY_PATH, "polygon mode")
    for b, s in zip(boxes, scores):
        if len(b) != len(s) or not all(
                p.dtype == np.int64 and p.ndim == 2 and p.shape[1] == 2
                for p in b) or not all(0.7 <= v <= 1.0 for v in s):
            raise AssertionError("malformed polygon result")
    log(f"polygon ok: the served batch of {N} through DevicePolyRepresenter, "
        f"polygons per image {[len(b) for b in boxes]}, launches "
        f"{launches}")
    scenes = torch.from_numpy(
        np.stack([kernel_scene(i) for i in range(N)])).to(preds.device)
    for name, maps in (("served batch", preds[..., 0]),
                       ("kernel scenes", scenes)):
        quartiles, copied = poly_stages(rep, maps)
        log(f"polygon timing ({name}, {'x'.join(map(str, maps.shape))}, "
            f"median of 11): ms "
            f"[q25, median, q75] {json.dumps(quartiles)}; copied to the host "
            f"{copied} B against {maps.numel() * 4} B of f32 map")
    return launches


def phase_check(pth: str) -> None:
    dev = torch.device("cuda")
    # the main path's box representer vs the host representer on rotated
    # rects: same count, final corners within 2.5 px
    prob = np.zeros((160, 160), np.float32)
    draw_rect(prob, 40, 40, 50, 14, 20, 0.95)
    draw_rect(prob, 110, 100, 60, 16, -35, 0.95)
    draw_rect(prob, 40, 120, 30, 12, 0, 0.95)
    batch = {"shape": [(160, 160)]}
    db, _ = DeviceBoxRepresenter(thresh=0.3, box_thresh=0.7)(
        batch, torch.from_numpy(prob)[None, ..., None].to(dev))
    dev_boxes = sorted((np.asarray(b, float) for b in db[0]),
                       key=lambda b: (b[0, 0], b[0, 1]))
    hb, hs = SegDetectorRepresenter(thresh=0.3, box_thresh=0.7)(
        batch, prob[None, ..., None])
    host = sorted((np.asarray(b, float) for b, s in zip(hb[0], hs[0])
                   if s > 0), key=lambda b: (b[0, 0], b[0, 1]))
    if not len(dev_boxes) == len(host) == 3:
        raise AssertionError(f"{len(dev_boxes)} device vs {len(host)} host "
                             f"boxes")
    gap = max(np.abs(d - h).max() for d, h in zip(dev_boxes, host))
    if gap >= 2.5:
        raise AssertionError(f"device corners {gap} px from host")
    # speckles ahead of text must not evict it (same count as the host)
    rng = np.random.RandomState(1)
    prob = np.zeros((320, 320), np.float32)
    for _ in range(6):
        draw_rect(prob, rng.randint(40, 280), rng.randint(40, 280), 50, 12,
                  rng.uniform(-40, 40), 0.9)
    for _ in range(140):
        x, y = rng.randint(2, 318), rng.randint(2, 318)
        prob[y:y + 2, x:x + 2] = np.maximum(prob[y:y + 2, x:x + 2], 0.4)
    batch = {"shape": [(320, 320)]}
    hb, hs = SegDetectorRepresenter(thresh=0.25, box_thresh=0.5)(
        batch, prob[None, ..., None])
    db, _ = DeviceBoxRepresenter(thresh=0.25, box_thresh=0.5)(
        batch, torch.from_numpy(prob)[None, ..., None].to(dev))
    n_host = sum(1 for s in hs[0] if s > 0)
    if not len(db[0]) == n_host > 0:
        raise AssertionError(f"speckle scene: {len(db[0])} device vs "
                             f"{n_host} host boxes")
    log(f"check ok: rect scene 3 boxes, corners within {gap:.3f} px of the "
        f"host; speckle scene {n_host} boxes on both paths")

    # the model on the card against the same weights on the CPU, both in
    # the fp32 parity configuration (TF32 off), so only summation order
    # differs
    from db_text_minimal_tpu_torch.cli.common import load_model

    x = torch.from_numpy(np.random.RandomState(SEED).rand(2, 64, 64, 3)
                         .astype(np.float32) * 2 - 1)
    with torch.inference_mode():
        on_card = load_model(pth, fuse_head=True,
                             dtype=torch.float32)(x.to(dev)).cpu()
        on_cpu = load_model(pth, device="cpu", fuse_head=True)(x)
    err = (on_card - on_cpu).abs().max().item()
    if not (torch.isfinite(on_card).all() and err < 1e-4):
        raise AssertionError(f"model on card vs CPU: max_abs_err {err}")
    log(f"check ok: model on the card vs the CPU, max_abs_err {err:.3g} "
        f"(tolerance 1e-4)")


def phase_check_polygon() -> None:
    """DevicePolyRepresenter on the card against the host polygon mode on
    the kernel scenes: the same polygons, scores within 2e-3 (the device
    scores a component with its holes, the host its filled contour; the
    JAX package's tolerance for the pair). K7 on the card against the same
    call on the CPU, which runs the plain versions, at 640x640 and at width
    100: packed bitmaps, bboxes and valid slots exact, scores within
    1e-6."""
    dev = torch.device("cuda")
    maps = np.stack([kernel_scene(i) for i in range(N)])
    shape = {"shape": [(SIZE, SIZE)] * N}
    db, ds = DevicePolyRepresenter()(shape, torch.from_numpy(maps).to(dev))
    hb, hs = SegDetectorRepresenter()(shape, maps[..., None],
                                      is_output_polygon=True)
    worst = 0.0
    for i in range(N):
        if len(db[i]) != len(hb[i]) or not all(
                np.array_equal(a, b) for a, b in zip(db[i], hb[i])):
            raise AssertionError(f"scene {i}: device polygons differ from "
                                 f"the host's")
        if db[i]:
            worst = max(worst, float(np.abs(np.subtract(ds[i], hs[i])).max()))
    if worst > 2e-3 or not any(db):
        raise AssertionError(f"polygon scores {worst} apart, polygons per "
                             f"scene {[len(b) for b in db]}")
    errs = []
    for size in (SIZE, 100):
        prob = np.stack([kernel_scene(i, size) for i in range(N)])
        on_card = cc.device_poly_stats(torch.from_numpy(prob).to(dev))
        on_cpu = cc.device_poly_stats(torch.from_numpy(prob))
        if not all(torch.equal(on_card[i].cpu(), on_cpu[i]) for i in (0, 1,
                                                                      3)):
            raise AssertionError(f"device_poly_stats at {size}: the card "
                                 f"and the CPU differ")
        errs.append((on_card[2].cpu() - on_cpu[2]).abs().max().item())
        if errs[-1] > 1e-6:
            raise AssertionError(f"device_poly_stats at {size}: score "
                                 f"error {errs[-1]}")
    log(f"check ok: device polygons equal the host's on {N} kernel scenes "
        f"({[len(b) for b in db]} per scene), scores within {worst:.3g} "
        f"(tolerance 2e-3); K7 on the card vs the CPU exact, score errors "
        f"{errs} at {SIZE} and 100 wide")


def train_config(workdir: str, size: int, batch: int, device: str,
                 dtype: str = "bfloat16"):
    cfg = default_config()
    cfg.meta.device = device
    cfg.meta.root_dir = workdir
    cfg.hps.img_size = size
    cfg.hps.batch_size = batch
    cfg.logging.logger_file = None
    cfg.parallel.compute_dtype = dtype
    return cfg


def train_run(workdir: str, batch_size: int, dtype: str):
    """TRAIN_STEPS steps of Trainer.train_epoch at SIZE x SIZE on one
    synthetic batch of ``batch_size``, in ``dtype`` (the config's
    ``parallel.compute_dtype``), then three more under the profiler. K2's
    counts are set to 0 before the epoch and read after it. Returns (K2
    launches, trainer, state)."""
    cfg = train_config(workdir, SIZE, batch_size, "cuda", dtype)
    cfg.metric.is_output_polygon = False     # rect-mode eval, on K3-K6
    batch = text_batch(SEED, batch_size, SIZE)
    events = []

    def loader():
        # an event before each step: consecutive events time one step on
        # the card's clock without a host synchronisation
        for _ in range(TRAIN_STEPS):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            yield batch

    tests = [text_batch(SEED + 1 + i, 1, SIZE) for i in range(2)]
    trainer = T.Trainer(cfg, loader(), tests)
    state = trainer.init_state()
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    if state.model.compute_dtype != want:
        raise AssertionError(f"{dtype}: the model computes in "
                             f"{state.model.compute_dtype}")
    D.reset_launches()
    state, _, _, _ = trainer.train_epoch(state, 0)
    events.append(torch.cuda.Event(enable_timing=True))
    events[-1].record()
    torch.cuda.synchronize()
    launches = dict(D.LAUNCHES)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    totals = [row["total_loss"] for row in trainer.loss_log]
    what = f"train ({dtype}, batch {batch_size})"
    if not all(np.isfinite(v) for row in trainer.loss_log
               for v in row.values()):
        raise AssertionError(f"{what}: a loss is not finite: "
                             f"{trainer.loss_log}")
    if len(totals) != TRAIN_STEPS or not np.mean(totals[-3:]) < totals[0]:
        raise AssertionError(f"{what}: the loss did not fall: {totals}")
    if not (launches["db_step_forward"] == launches["db_step_backward"]
            == TRAIN_STEPS and launches["fused_db_step"] == 0):
        raise AssertionError(f"{what}: K2 launches {launches} in "
                             f"{TRAIN_STEPS} steps")
    q25, med, q75 = (float(q) for q in np.percentile(step_ms[2:],
                                                     [25, 50, 75]))
    log(f"{what} ok: {TRAIN_STEPS} steps at {SIZE}x{SIZE}, total loss "
        f"{totals[0]:.4f} -> {np.mean(totals[-3:]):.4f} (mean of the last "
        f"3); K2 launches {launches['db_step_forward']} forward, "
        f"{launches['db_step_backward']} backward")
    log(f"{what} timing: ms per step over the last 10 steps [q25, median, "
        f"q75] [{q25:.3f}, {med:.3f}, {q75:.3f}], "
        f"{batch_size * 1e3 / med:.2f} img/s; all steps ms "
        f"{json.dumps([round(v, 3) for v in step_ms])}")

    # three more steps under the profiler: the card's busy time per step
    # and the kernels that take it
    step = T.build_train_step(cfg)
    device_batch = T.to_device(batch, torch.device("cuda"))
    busy_ms, by_name, _ = device_kernels(
        lambda: step(state, device_batch, LR), 3)
    k2_ms = sum(v for k, v in by_name.items() if "_db_step_" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"{what} profile: the card busy {busy_ms:.3f} ms per step "
        f"({100 * busy_ms / med:.2f} % of the median step; idle "
        f"{100 * (1 - busy_ms / med):.2f} %); K2 forward + backward "
        f"{k2_ms:.4f} ms = {100 * k2_ms / med:.4f} % of the step; top "
        f"kernels ms per step "
        f"{json.dumps({k[:60]: round(v, 4) for k, v in top})}")
    return launches, trainer, state


def phase_train(workdir: str) -> dict:
    """The default configuration (bf16) at batch 4 is the main path, whose
    K2 launches the kernels line reports and whose state the evals below
    take; then fp32 at batch 4 and both at batch 16, for their times."""
    launches, trainer, state = train_run(workdir, TRAIN_BATCH, "bfloat16")
    for batch_size, dtype in ((TRAIN_BATCH, "float32"),
                              (QUALITY_BATCH, "bfloat16"),
                              (QUALITY_BATCH, "float32")):
        train_run(workdir, batch_size, dtype)
    tests = trainer.test_loader

    cc.reset_launches()
    test_loss, _, recall, precision, hmean = trainer.eval_epoch(state)
    torch.cuda.synchronize()
    eval_launches = dict(cc.LAUNCHES)
    check_launches(eval_launches, RECT_PATH, "rect-mode eval")
    check_prf("rect-mode eval", test_loss, precision, recall, hmean)
    log(f"train eval ok: rect mode on 2 images, test loss {test_loss:.4f}, "
        f"P {precision:.4f} R {recall:.4f} F {hmean:.4f}, launches "
        f"{eval_launches}")

    # the default configuration evaluates in polygon mode, on the host
    # representer over a host copy of the preds (the JAX trainer's rule)
    cfg_poly = train_config(workdir, SIZE, TRAIN_BATCH, "cuda")
    if not cfg_poly.metric.is_output_polygon:
        raise AssertionError("the default configuration is not polygon mode")
    test_loss, _, recall, precision, hmean = T.Trainer(
        cfg_poly, None, tests).eval_epoch(state)
    check_prf("polygon-mode eval", test_loss, precision, recall, hmean)
    log(f"train eval ok: the default configuration (polygon mode) on 2 "
        f"images, test loss {test_loss:.4f}, P {precision:.4f} R "
        f"{recall:.4f} F {hmean:.4f}")

    # the quality bench's eval: host and device, rect and polygon rows on
    # the same preds, at the reference's eval constants (0.25, 0.5)
    args = quality_bench.load_args(["--data_dir", workdir, "--out",
                                    os.path.join(workdir, "unused.json"),
                                    "--polygon", "--img_size", str(SIZE)])
    cc.reset_launches()
    out = quality_bench.full_eval(trainer, state, tests, args)
    torch.cuda.synchronize()
    bench_launches = dict(cc.LAUNCHES)
    check_launches(bench_launches, RECT_PATH + POLY_PATH, "full_eval")
    for row in ("host", "device", "host_poly", "device_poly"):
        for proto in ("iou_pascal", "deteval"):
            check_prf(f"full_eval {row} {proto}", 0.0,
                      *(out[row][proto][k]
                        for k in ("precision", "recall", "hmean")))
    log(f"quality bench full_eval ok on 2 images: {json.dumps(out)}; "
        f"launches {bench_launches}")
    return launches


def calibrate_bn(model: torch.nn.Module, x: torch.Tensor) -> None:
    """Every BN's running mean set to the batch ``x``'s mean and its
    running variance to the batch's variance plus 1 (one train-mode
    forward at momentum 1, no gradient), so that the activations of a
    random deep network stay of order 1 as a trained one's do; with the
    init's statistics a seeded resnet50's grow until two summation orders
    of one fp32 forward lie a mean 0.10 apart on 640² maps."""
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    for m in bns:
        m.momentum = 0.1
        m.running_var += 1.0
    model.eval()


def family_pth(workdir: str, backbone: str, neck: str,
               x: torch.Tensor) -> str:
    """A seeded model of the family at full width, its offset branches
    (zero at init) drawn from N(0, OFFSET_STD) so that every tap samples
    off the grid, its BN statistics calibrated on the float batch ``x`` on
    the card, saved as a ``.pth`` with the port's keys."""
    model = DBTextModel(backbone_name=backbone, neck_name=neck)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "offset_conv" in name:
                p.normal_(0.0, OFFSET_STD, generator=g)
    calibrate_bn(model.cuda(), x)
    pth = os.path.join(workdir, f"dbnet_{backbone}_{neck}_seed.pth")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, pth)
    return pth


def dcn_ranges(model: torch.nn.Module) -> list:
    """A ``record_function("DeformConv")`` range around every deformable
    conv's forward (hooks; returns their handles)."""
    from torch.profiler import record_function

    from db_text_minimal_tpu_torch.models import DeformConv

    def enter(mod, args):
        mod._range = record_function("DeformConv")
        mod._range.__enter__()

    def leave(mod, args, out):
        mod._range.__exit__(None, None, None)

    handles = []
    for m in model.modules():
        if isinstance(m, DeformConv):
            handles += [m.register_forward_pre_hook(enter),
                        m.register_forward_hook(leave)]
    return handles


def _device_ms(e) -> float:
    total = getattr(e, "device_time_total", None)
    if total is None:
        total = e.cuda_time_total
    return total / 1e3


def dcn_share(model: torch.nn.Module, fn, reps: int = 1) -> dict:
    """DeformConv's share of the card's time in ``fn`` (a forward, or a
    train step of ``model``) by torch.profiler: the kernels under the
    ``DeformConv`` ranges (``dcn_ranges``) and, in a step, those of the
    backward nodes that share a sequence number with an op inside a range,
    against every kernel of the window, per call; and D1's two kernels'
    time by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    handles = dcn_ranges(model)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    events = prof.events()
    # the ranges also show on the device's timeline as annotations, which
    # span kernels rather than being any
    total = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == DeviceType.CUDA
                and e.name != "DeformConv"
                and not getattr(e, "is_user_annotation", False)) / 1e3 / reps
    ranges = [e for e in events if e.name == "DeformConv"
              and e.device_type == DeviceType.CPU]
    fwd = sum(_device_ms(e) for e in ranges) / reps
    seqs, stack = set(), [c for e in ranges for c in e.cpu_children]
    while stack:
        e = stack.pop()
        if getattr(e, "sequence_nr", -1) >= 0:
            seqs.add(e.sequence_nr)
        stack.extend(e.cpu_children)
    bwd_events = [e for e in events
                  if e.name.startswith("autograd::engine::evaluate_function")
                  and getattr(e, "sequence_nr", -1) in seqs]
    bwd = sum(_device_ms(e) for e in bwd_events) / reps
    d1 = {name: sum(e.time_range.elapsed_us() for e in events
                    if e.device_type == DeviceType.CUDA
                    and f"{name}_kernel" in e.name) / 1e3 / reps
          for name in DF.LAUNCHES}
    return {"device_ms": total, "dcn_fwd_ms": fwd, "dcn_bwd_ms": bwd,
            "d1_im2col_ms": d1["deform_im2col"],
            "d1_col2im_ms": d1["deform_col2im"],
            "share": (fwd + bwd) / total if total else float("nan"),
            "ranges": len(ranges) // reps,
            "bwd_nodes": len(bwd_events) // reps}


def family_train(workdir: str, backbone: str, neck: str, batch_size: int,
                 steps: int, mult: float):
    """``steps`` bf16 steps of Trainer.train_epoch on one synthetic batch
    (SIZE², ``batch_size``), the offsets under ``dcn_offset_lr_mult``
    ``mult``, an event before each step. Returns (K2 launches, step ms,
    total losses, the largest move of an offset weight, trainer, state)."""
    cfg = train_config(workdir, SIZE, batch_size, "cuda")
    cfg.model.backbone, cfg.model.neck = backbone, neck
    cfg.optimizer.dcn_offset_lr_mult = mult
    batch = text_batch(SEED, batch_size, SIZE)
    events = []

    def loader():
        for _ in range(steps):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            yield batch

    trainer = T.Trainer(cfg, loader(), None)
    state = trainer.init_state()
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters() if "offset_conv" in n}
    D.reset_launches()
    state, _, _, _ = trainer.train_epoch(state, 0)
    events.append(torch.cuda.Event(enable_timing=True))
    events[-1].record()
    torch.cuda.synchronize()
    launches = dict(D.LAUNCHES)
    params = dict(state.model.named_parameters())
    moved = max(((params[n].detach() - v).abs().max().item()
                 for n, v in before.items()), default=0.0)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    totals = [row["total_loss"] for row in trainer.loss_log]
    return launches, step_ms, totals, moved, trainer, state


def _plain_bilinear_sample(flat, n, h, w, y, x):
    """The plain module's sampling of one tap before D1's kernels: four
    gathers of the (N·H·W, C) rows ``flat`` at (y, x), each (N, OH, OW),
    zero outside the image."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    image = (torch.arange(n, device=flat.device) * (h * w))[:, None, None]

    def gather(yy, xx):
        valid = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
        yc = yy.clamp(0, h - 1).long()
        xc = xx.clamp(0, w - 1).long()
        vals = flat[(image + yc * w + xc).reshape(-1)]
        return torch.where(valid, vals.reshape(*yy.shape, -1), 0.0)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def plain_deform_forward(self, x):
    """``DeformConv.forward`` as the port ran it before D1's kernels (PR
    14's module, line for line): tap by tap, the four gathers of the tap
    in PyTorch and its product added at once, in the compute dtype; the
    backward by autograd (an indexed scatter a gather)."""
    n, c, h, w = x.shape
    s = self.stride
    oh, ow = (h + s - 1) // s, (w + s - 1) // s
    xf = x.float()
    offsets = self.offset_conv(xf)
    flat = xf.permute(0, 2, 3, 1).reshape(-1, c)
    base_y = (torch.arange(oh, device=x.device, dtype=torch.float32)
              * s)[None, :, None]
    base_x = (torch.arange(ow, device=x.device, dtype=torch.float32)
              * s)[None, None, :]
    dt = self.compute_dtype
    out = torch.zeros(n * oh * ow, self.weight.shape[0], dtype=dt,
                      device=x.device)
    for ky in range(3):
        for kx in range(3):
            tap = ky * 3 + kx
            sy = base_y + (ky - 1) + offsets[:, 2 * tap]
            sx = base_x + (kx - 1) + offsets[:, 2 * tap + 1]
            sampled = _plain_bilinear_sample(flat, n, h, w, sy, sx)
            out = out + sampled.reshape(-1, c).to(dt) @ \
                self.weight[:, :, ky, kx].t().to(dt)
    return out.reshape(n, oh, ow, -1).permute(0, 3, 1, 2)


class plain_deform:
    """Within the block, every ``DeformConv`` of ``models`` runs
    ``plain_deform_forward`` (bound on the instance), not D1's kernels."""

    def __init__(self, *models):
        from db_text_minimal_tpu_torch.models import DeformConv

        self.convs = [m for model in models for m in model.modules()
                      if isinstance(m, DeformConv)]

    def __enter__(self):
        for m in self.convs:
            m.forward = plain_deform_forward.__get__(m)
        return self

    def __exit__(self, *exc):
        for m in self.convs:
            del m.forward


def in_turns(models, fns: dict) -> dict:
    """Each of ``fns`` (name -> call) timed by ``event_median`` with D1's
    kernels, then with the plain function swapped into ``models``, TURNS
    times: {name: {"kernel": [ms...], "plain": [ms...]}}."""
    out = {name: {"kernel": [], "plain": []} for name in fns}
    for _ in range(TURNS):
        for variant in ("kernel", "plain"):
            for name, fn in fns.items():
                if variant == "plain":
                    with plain_deform(*models):
                        ms = event_median(fn, FAMILY_REPS)
                else:
                    ms = event_median(fn, FAMILY_REPS)
                out[name][variant].append(ms)
    return out


def phase_families(workdir: str) -> dict:
    """Every other detector family the JAX package builds, at full width
    (see the module): served in box mode through the handler given the
    loaded model's forward, bf16 against fp32, timed; card against CPU;
    three bf16 train steps of two; a step at batch 16 timed; DeformConv's
    share; deformable_resnet18 (fp32) exported and served from its
    archive.
    Returns the K3-K6 and K2 launches of the phase's runs."""
    from db_text_minimal_tpu_torch.cli.common import load_model

    t_phase = time.perf_counter()
    request = [{"body": b} for b in synthetic_images()]
    batch_u8 = DBTextDetectionHandler(device="cuda").preprocess(request)
    DF.reset_launches()
    mean = torch.tensor(CAFFE_MEAN, device="cuda")
    x = torch.from_numpy(batch_u8).cuda().float() - mean
    served, timing, shares, pths = {}, {}, {}, {}
    for backbone, neck in FAMILY_SERVE:
        t_family = time.perf_counter()
        name = f"{backbone}+{neck}"
        pths[name] = pth = family_pth(workdir, backbone, neck, x)
        models = {dt: load_model(pth, backbone=backbone, neck=neck,
                                 dtype=dt)
                  for dt in (torch.bfloat16, torch.float32)}

        def forward(u8, model=models[torch.bfloat16]):
            with torch.inference_mode():
                return model(torch.from_numpy(u8).cuda().float() - mean)

        handler = DBTextDetectionHandler(forward=forward, device="cuda")
        cc.reset_launches()
        d1_before = dict(DF.LAUNCHES)
        result = handler.handle(request, mode="boxes")
        torch.cuda.synchronize()
        launches = dict(cc.LAUNCHES)
        check_launches(launches, RECT_PATH, f"families, {name}, box mode")
        check_box_result(result)
        d1 = {k: DF.LAUNCHES[k] - d1_before[k] for k in DF.LAUNCHES}
        if d1 != {"deform_im2col": DCN_CONVS.get(backbone, 0),
                  "deform_col2im": 0}:
            raise AssertionError(f"{name}: D1 launches {d1} in one served "
                                 f"forward")
        launches.update(d1)
        served[name] = launches
        with torch.inference_mode():
            p16 = models[torch.bfloat16](x)
            p32 = models[torch.float32](x)
            gap = (p16 - p32).abs().mean().item()
            if not (p16.dtype == torch.float32 and 0 < gap < 0.02
                    and torch.isfinite(p32).all()):
                raise AssertionError(f"{name}: bf16 maps vs fp32, mean abs "
                                     f"{gap}")
            calls = {dt: lambda m=models[d]: m(x)
                     for dt, d in (("bf16", torch.bfloat16),
                                   ("fp32", torch.float32))}
            if backbone in DCN_CONVS:
                turns = in_turns(list(models.values()), calls)
                timing[name] = {dt: float(np.median(t["kernel"]))
                                for dt, t in turns.items()}
                timing[name].update({f"{dt}_plain": float(np.median(
                    t["plain"])) for dt, t in turns.items()})
                timing[name]["turns"] = turns
            else:
                timing[name] = {dt: event_median(fn, FAMILY_REPS)
                                for dt, fn in calls.items()}
        if backbone == "deformable_resnet50":
            with torch.inference_mode():
                shares["forward"] = dcn_share(
                    models[torch.bfloat16],
                    lambda m=models[torch.bfloat16]: m(x))
        if backbone == "deformable_resnet18":
            # fp32: in bf16 the live forward of one image differs from its
            # forward in a pair (the products' algorithms differ with M)
            t0 = time.perf_counter()
            path = export_model(
                models[torch.float32], os.path.join(workdir, "dr18.pt2"),
                input_shape=(None, SIZE, SIZE, 3))
            log(f"families export ({name}, flax mode, fp32): export and "
                f"save {time.perf_counter() - t0:.2f} s, "
                f"{os.path.getsize(path)} bytes")

            def live(u8, model=models[torch.float32]):
                with torch.inference_mode():
                    return model(u8.float() - mean)

            drive_export(f"{name} flax archive", load_exported(path), live,
                         batch_u8, 0, want_d1=DCN_CONVS[backbone])
        plain_note = (f" (the plain DeformConv in turns: bf16 "
                      f"{timing[name]['bf16_plain']:.3f} ms, fp32 "
                      f"{timing[name]['fp32_plain']:.3f} ms)"
                      if backbone in DCN_CONVS else "")
        log(f"families ok: {name} served a batch of {N} in box mode (boxes "
            f"per image {[len(r['boxes']) for r in result]}, launches "
            f"{launches}); bf16 vs fp32 maps mean abs {gap:.3g} (bound "
            f"0.02); forward at batch {N}, {SIZE}x{SIZE}, median of "
            f"{FAMILY_REPS} by CUDA events: bf16 "
            f"{timing[name]['bf16']:.3f} ms, fp32 "
            f"{timing[name]['fp32']:.3f} ms{plain_note}; "
            f"{time.perf_counter() - t_family:.1f} s with the .pth and the "
            f"loads")
        del models, handler, p16, p32
        torch.cuda.empty_cache()

    # card against CPU, fp32 with TF32 off, one image
    for backbone, neck in FAMILY_CHECK:
        name = f"{backbone}+{neck}"
        with torch.inference_mode():
            on_card = load_model(pths[name], backbone=backbone, neck=neck,
                                 dtype=torch.float32)(x[:1]).cpu()
            on_cpu = load_model(pths[name], device="cpu", backbone=backbone,
                                neck=neck)(x[:1].cpu())
        err = (on_card - on_cpu).abs().max().item()
        if not (torch.isfinite(on_card).all() and err < FAMILY_TOL):
            raise AssertionError(f"{name} on the card vs the CPU: "
                                 f"max_abs_err {err}")
        log(f"families check ok: {name} fp32 forward at 1x{SIZE}x{SIZE} on "
            f"the card vs the CPU, max_abs_err {err:.3g} (tolerance "
            f"{FAMILY_TOL}), mean {(on_card - on_cpu).abs().mean():.3g}")

    # training: three bf16 steps at batch 4 (K2 each step, finite losses,
    # the offsets move); then a step at batch 16 timed, and profiled
    train_launches = {}
    for backbone, neck in FAMILY_CHECK:
        name = f"{backbone}+{neck}"
        mult = 0.1 if backbone.startswith("deformable") else 1.0
        launches, _, totals, moved, _, _ = family_train(
            workdir, backbone, neck, TRAIN_BATCH, FAMILY_STEPS, mult)
        if not (launches["db_step_forward"] == launches["db_step_backward"]
                == FAMILY_STEPS and all(np.isfinite(totals))
                and len(totals) == FAMILY_STEPS):
            raise AssertionError(f"{name} train: K2 launches {launches}, "
                                 f"losses {totals}")
        if backbone.startswith("deformable") and not moved > 0:
            raise AssertionError(f"{name} train: the offsets did not move")
        train_launches[name] = launches
        _, step_ms, _, _, trainer, state = family_train(
            workdir, backbone, neck, QUALITY_BATCH, FAMILY_TIMED_STEPS,
            mult)
        med = float(np.median(step_ms[2:]))
        timing[name]["train_bf16_b16"] = med
        log(f"families train ok: {name}, {FAMILY_STEPS} bf16 steps at batch "
            f"{TRAIN_BATCH}, total loss {[round(v, 4) for v in totals]}, K2 "
            f"launches {launches}, largest offset move {moved:.3g} "
            f"(dcn_offset_lr_mult {mult}); a step at batch {QUALITY_BATCH}, "
            f"bf16, median of the last {FAMILY_TIMED_STEPS - 2} of "
            f"{FAMILY_TIMED_STEPS}: {med:.3f} ms (all steps ms "
            f"{json.dumps([round(v, 3) for v in step_ms])})")
        if backbone == "deformable_resnet50":
            step = T.build_train_step(trainer.cfg)
            device_batch = T.to_device(text_batch(SEED, QUALITY_BATCH, SIZE),
                                       torch.device("cuda"))
            shares["step"] = dcn_share(
                state.model, lambda: step(state, device_batch, LR))
        del trainer, state
        torch.cuda.empty_cache()
    # the deformable families' bf16 step at batch 16, D1's kernels against
    # the plain function, in turns; D1's launches in one step
    d1_step = {}
    for backbone in DCN_CONVS:
        name = f"{backbone}+FPN"
        _, _, _, _, trainer, state = family_train(
            workdir, backbone, "FPN", QUALITY_BATCH, 1, 0.1)
        step = T.build_train_step(trainer.cfg)
        device_batch = T.to_device(text_batch(SEED, QUALITY_BATCH, SIZE),
                                   torch.device("cuda"))
        DF.reset_launches()
        step(state, device_batch, LR)
        torch.cuda.synchronize()
        d1_step[name] = dict(DF.LAUNCHES)
        want = DCN_CONVS[backbone]
        if d1_step[name] != {"deform_im2col": want, "deform_col2im": want}:
            raise AssertionError(f"{name}: D1 launches {d1_step[name]} in "
                                 f"one train step")
        turns = in_turns([state.model], {
            "step": lambda: step(state, device_batch, LR)})["step"]
        timing[name]["train_bf16_b16"] = float(np.median(turns["kernel"]))
        timing[name]["train_bf16_b16_plain"] = float(np.median(
            turns["plain"]))
        timing[name]["train_turns"] = turns
        log(f"families train turns: {name}, a bf16 step at batch "
            f"{QUALITY_BATCH}, median of {FAMILY_REPS} a turn, ms: "
            f"{json.dumps(turns)}; D1 launches in one step "
            f"{d1_step[name]}")
        del trainer, state
        torch.cuda.empty_cache()
    for what, share in shares.items():
        share = {k: round(v, 4) if isinstance(v, float) else v
                 for k, v in share.items()}
        log(f"families DCN share ({what}, deformable_resnet50, batch "
            f"{N if what == 'forward' else QUALITY_BATCH}, bf16): "
            f"{json.dumps(share)}")
    log(f"families timing: {json.dumps(timing)}")
    log(f"families phase: {time.perf_counter() - t_phase:.1f} s")
    return {"served": served, "train": train_launches, "d1_step": d1_step}


def reset_all_launches() -> None:
    for module in (cc, D, I8, DF):
        module.reset_launches()


def all_launches() -> dict:
    return {**cc.LAUNCHES, **D.LAUNCHES, **I8.LAUNCHES, **DF.LAUNCHES}


def check_report(what: str, report: dict, rows: tuple) -> None:
    """The JAX report's keys, and finite P/R/F in [0, 1] in every row."""
    if (list(report) != REPORT_KEYS
            or list(report["config"]) != CONFIG_KEYS):
        raise AssertionError(f"{what}: report keys {list(report)}, config "
                             f"keys {list(report['config'])}")
    results = report["results"]
    if sorted(k for k in results if k != "n_test_images") != sorted(rows):
        raise AssertionError(f"{what}: rows {list(results)}")
    for row in rows:
        for proto in ("iou_pascal", "deteval"):
            check_prf(f"{what} {row} {proto}", 0.0,
                      *(results[row][proto][k]
                        for k in ("precision", "recall", "hmean")))


def phase_quality(workdir: str) -> dict:
    """The quality bench end to end at full width: a small hard set from
    the port's generator (QUALITY_TRAIN + QUALITY_TEST images at 640x640,
    seed 7) under the committed trace of cv2 5.0.0's text engine, which
    holds each image's GT to the trace's hash (the first 48 images of the
    committed benchmark's stream), ``quality_bench.main`` for one epoch at
    batch 16, in bf16, with
    ``--reduction none --polygon --save_checkpoint`` (K2 in every step,
    K3-K7 in the eval's rows), then ``--eval_only --quant`` on that
    checkpoint (the int8 conv's kernel, K3-K6 in the device row). The
    counts are set to 0 before each run and read after it. Also the host
    ms of a training sample (decode, augment, labels) on one thread."""
    import cv2

    from db_text_minimal_tpu_torch.cli.record_text_engine import TRACE
    from db_text_minimal_tpu_torch.data import TotalTextDataset
    from db_text_minimal_tpu_torch.data.synthetic import generate_hard
    from db_text_minimal_tpu_torch.data.text_engine import ReplayTextEngine

    t_phase = t0 = time.perf_counter()
    data_dir = os.path.join(workdir, "hard")
    engine = ReplayTextEngine(TRACE)
    section = generate_hard(data_dir, n_train=QUALITY_TRAIN,
                            n_test=QUALITY_TEST, seed=7, text_engine=engine)
    gen_s = time.perf_counter() - t0
    if engine.images != QUALITY_TRAIN + QUALITY_TEST:
        raise AssertionError(f"quality: {engine.images} images replayed")
    dataset = TotalTextDataset(section["train_dir"], section["train_gt_dir"],
                               ["###"], compact_dtypes=True)
    t0 = time.perf_counter()
    for i in range(len(dataset)):
        dataset[i]
    sample_ms = (time.perf_counter() - t0) * 1e3 / len(dataset)

    ckpt = os.path.join(workdir, "quality.ckpt")
    common = ["--data_dir", data_dir, "--batch_size", str(QUALITY_BATCH),
              "--test_batch_size", str(QUALITY_BATCH), "--reduction",
              "none", "--thresh", "0.25", "--box_thresh", "0.5"]
    reset_all_launches()
    report = quality_bench.main(quality_bench.load_args(common + [
        "--epochs", "1", "--polygon", "--save_checkpoint", ckpt, "--out",
        os.path.join(workdir, "quality.json")]))
    torch.cuda.synchronize()
    launches = all_launches()
    steps = QUALITY_TRAIN // QUALITY_BATCH
    if not (launches["db_step_forward"] == launches["db_step_backward"]
            == steps):
        raise AssertionError(f"quality: K2 launches {launches} in {steps} "
                             f"steps")
    check_launches(launches, RECT_PATH + POLY_PATH, "quality bench")
    check_report("quality bench", report,
                 ("host", "device", "host_poly", "device_poly"))
    if report["config"]["compute_dtype"] != "bfloat16":
        raise AssertionError(f"quality: trained in "
                             f"{report['config']['compute_dtype']}")

    reset_all_launches()
    report_q = quality_bench.main(quality_bench.load_args(common + [
        "--eval_only", "--checkpoint", ckpt, "--quant", "--out",
        os.path.join(workdir, "quality_int8.json")]))
    torch.cuda.synchronize()
    launches_q = all_launches()
    if launches_q["int8_conv"] == 0:
        raise AssertionError(f"quality --quant: the int8 conv never "
                             f"launched {launches_q}")
    check_launches(launches_q, RECT_PATH, "quality bench --quant")
    check_report("quality bench --quant", report_q, ("host", "device"))
    if not report_q["config"]["train_config"]["reduction"] == "none":
        raise AssertionError("quality --quant: the checkpoint's sidecar "
                             "was not read")

    epoch = report["history"][0]
    results = {name: {"deteval_f": r["results"][row]["deteval"]["hmean"],
                      "postprocess_wall_s": r["results"][row][
                          "postprocess_wall_s"]}
               for name, r, row in (
                   ("host", report, "host"), ("device", report, "device"),
                   ("host_poly", report, "host_poly"),
                   ("device_poly", report, "device_poly"),
                   ("int8 host", report_q, "host"),
                   ("int8 device", report_q, "device"))}
    log(f"quality ok: {QUALITY_TRAIN} train and {QUALITY_TEST} test images "
        f"of generate_hard at 640x640 made in {gen_s:.2f} s by replaying "
        f"the committed text-engine trace (recorded under cv2 "
        f"{engine.header['cv2']}; here cv2 {cv2.__version__}): every GT "
        f"equal to the trace's, {engine.pixels_equal} of "
        f"{engine.images} images with the recorded pixels; one epoch of "
        f"{steps} steps at batch {QUALITY_BATCH}, train_wall_s "
        f"{report['train_wall_s']}, eval_wall_s {report['eval_wall_s']}, "
        f"int8 eval_wall_s {report_q['eval_wall_s']}; the epoch "
        f"{epoch['wall_s']} s, of which waiting on the loader "
        f"{epoch['loader_wait_s']} s, a sample {epoch['sample_ms']} ms in a "
        f"loader thread; BaseDataset.__getitem__ on one thread "
        f"{sample_ms:.2f} ms a training sample; rows {json.dumps(results)}; "
        f"launches {json.dumps(launches)}, --quant {json.dumps(launches_q)}; "
        f"the phase took {time.perf_counter() - t_phase:.2f} s")
    return launches


def median_ms(fn, reps: int = 11) -> float:
    """Median milliseconds of ``fn`` on the card over ``reps`` runs after
    two warm-up runs, from CUDA events around each run."""
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def rec_model(stages, device: str):
    """A full-width recognizer of ``stages`` with the seeded weights."""
    from db_text_minimal_tpu_torch.models.recognition import \
        RecognitionModel

    model = RecognitionModel(37 if stages[3] == "CTC" else 38, *stages,
                             **REC_WIDTH)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model.to(device).flatten_parameters().eval()


def phase_ocr(workdir: str) -> dict:
    """The recognizer and the OCR path at full width, on the quality
    phase's hard set and its ``quality.ckpt`` detector (see the module).
    Returns the int8 kernels' launches in cli.ocr's int8 run."""
    import cv2

    from db_text_minimal_tpu_torch.cli import ocr, rec_bench, train_rec
    from db_text_minimal_tpu_torch.data.synthetic import export_word_crops
    from db_text_minimal_tpu_torch.models.recognition import (
        AttnLabelConverter, CTCLabelConverter)
    from db_text_minimal_tpu_torch.train import recognition_trainer as RT
    from db_text_minimal_tpu_torch.utils import read_img, test_preprocess

    t_phase = t0 = time.perf_counter()
    data_dir = os.path.join(workdir, "hard")
    section = {"train_dir": os.path.join(data_dir, "train_images"),
               "train_gt_dir": os.path.join(data_dir, "train_gts")}
    crop_dir = export_word_crops(section, os.path.join(workdir, "crops"))
    export_s = time.perf_counter() - t0
    base = ["--FeatureExtraction", "VGG", "--Prediction", "CTC"]
    images, texts = train_rec.load_crop_dataset(train_rec.load_args(
        ["--crop_dir", crop_dir] + base))
    if len(texts) < max(REC_BATCH, REC_TRAIN_BATCH * REC_STEPS // 4):
        raise AssertionError(f"ocr: only {len(texts)} crops exported")
    batch = images[:REC_BATCH]

    rows = {}
    for stages in REC_CONFIGS:
        name = "/".join(stages)
        gpu, cpu = rec_model(stages, "cuda"), rec_model(stages, "cpu")
        x = torch.from_numpy(batch)
        with torch.inference_mode():
            got = gpu(x.cuda()).float().cpu()
            ref = cpu(x)
        gap = (got - ref).abs().max().item()
        if not gap <= REC_TOL:
            raise AssertionError(f"ocr {name}: card logits {gap} from the "
                                 f"CPU's (tolerance {REC_TOL})")
        top2 = ref.topk(2, dim=-1).values
        sure = ((top2[..., 0] - top2[..., 1]) > REC_TOL).all(dim=1)
        same = (got.argmax(-1) == ref.argmax(-1)).all(dim=1)
        if not bool(same[sure].all()):
            raise AssertionError(f"ocr {name}: greedy strings differ where "
                                 f"every margin exceeds {REC_TOL}")
        xc = x.cuda()
        with torch.inference_mode():
            ms = median_ms(lambda: gpu(xc))
        rows[name] = {"logit_gap": gap, "max_abs_logit":
                      ref.abs().max().item(), "sure_rows": int(sure.sum()),
                      "forward_ms_b64": ms,
                      "crops_per_s": REC_BATCH / ms * 1e3}
        if gpu.transformation is not None:
            # the TPS stage alone, and its sampler on the grid it made
            xn = xc.permute(0, 3, 1, 2)
            with torch.inference_mode():
                rows[name]["tps_ms_b64"] = median_ms(
                    lambda: gpu.transformation(xn))
                loc = gpu.transformation.localization(xn)
                grid = torch.matmul(gpu.transformation.phat(32, 100, "cuda"),
                                    torch.matmul(
                                        gpu.transformation.inv_delta,
                                        torch.nn.functional.pad(
                                            loc, (0, 0, 0, 3))))
                grid = grid.reshape(-1, 32, 100, 2)
                rows[name]["grid_sample_ms_b64"] = median_ms(
                    lambda: torch.nn.functional.grid_sample(
                        xn, grid, align_corners=True))
        del gpu, cpu

    train_ms = {}
    for stages in (REC_CONFIGS[0], REC_CONFIGS[1]):
        conv = (CTCLabelConverter if stages[3] == "CTC"
                else AttnLabelConverter)("0123456789abcdefghijklmnopqrst"
                                         "uvwxyz")
        state = RT.init_rec_state(rec_model(stages, "cpu"), seed=SEED,
                                  device="cuda")
        step = RT.build_rec_train_step(state)
        targets, lengths = conv.encode(texts, 25)
        times, losses = [], []
        for k in range(REC_STEPS):
            sl = slice(k * REC_TRAIN_BATCH, (k + 1) * REC_TRAIN_BATCH)
            args = [torch.from_numpy(a[sl]).cuda()
                    for a in (images, targets, lengths)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(*args, 1e-3)))
            times.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(losses).all():
            raise AssertionError(f"ocr train {stages}: losses {losses}")
        train_ms["/".join(stages)] = {
            "step_ms_b32": float(np.median(times[2:])),
            "loss_first": losses[0], "loss_last": losses[-1]}
        del state, step

    rec_ckpt = os.path.join(workdir, "rec.ckpt")
    t0 = time.perf_counter()
    train_rec.main(train_rec.load_args(
        ["--crop_dir", crop_dir, "--out", rec_ckpt, "--epochs", "2"] + base))
    train_rec_s = time.perf_counter() - t0
    bench = ["--data_dir", data_dir, "--saved_model", rec_ckpt] + base
    t0 = time.perf_counter()
    rec = rec_bench.main(rec_bench.load_args(
        ["--mode", "rec", "--out", os.path.join(workdir, "rec.json")]
        + bench))
    rec_s = time.perf_counter() - t0
    det_ckpt = os.path.join(workdir, "quality.ckpt")
    t0 = time.perf_counter()
    e2e = rec_bench.main(rec_bench.load_args(
        ["--mode", "e2e", "--det_model_path", det_ckpt, "--out",
         os.path.join(workdir, "e2e.json")] + bench))
    e2e_s = time.perf_counter() - t0
    if list(rec) != REC_KEYS or list(e2e) != E2E_KEYS:
        raise AssertionError(f"ocr: report keys {list(rec)}, {list(e2e)}")
    if not (rec["total"] > 0 and e2e["n_gt_words"] > 0):
        raise AssertionError(f"ocr: empty reports {rec}, {e2e}")
    for key in ("word_accuracy", "det_hmean", "e2e_hmean"):
        value = rec.get(key, e2e.get(key))
        if not 0.0 <= value <= 1.0:
            raise AssertionError(f"ocr: {key} {value}")

    image = os.path.join(data_dir, "test_images",
                         sorted(os.listdir(os.path.join(data_dir,
                                                        "test_images")))[0])
    opt = ocr.load_args(["--img_path", image, "--det_model_path", det_ckpt,
                         "--saved_model", rec_ckpt, "--infer_mode", "int8",
                         "--out_path", os.path.join(workdir, "ocr.jpg")]
                        + base)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        reset_all_launches()
        results = ocr.main(opt)
        torch.cuda.synchronize()
        i8 = dict(I8.LAUNCHES)
        if i8["int8_conv"] == 0:
            raise AssertionError(f"ocr --infer_mode int8: the int8 conv "
                                 f"never launched {i8}")
        # the stages, timed apart: the int8 detector's forward, the host
        # postprocess and warps, and the per-crop recognition, this on the
        # image's GT words (the one-epoch detector may find none)
        model, det_fwd = build_inference_forward(det_ckpt,
                                                 infer_mode="int8")
        converter = ocr.build_converter(opt)
        recognizer = ocr.load_rec_model(opt, len(converter.character))
        img, h, w = read_img(image)
        gt_crops = [rec_bench._warp_crop(img, poly) for poly, _ in
                    next(rec_bench._test_words(rec_bench.load_args(
                        ["--mode", "rec", "--out", "x", "--limit", "1"]
                        + bench)))[1]]
        stages_ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det_fwd(test_preprocess(img)).cpu()
            t1 = time.perf_counter()
            ocr.detect_and_crop(opt, model, img, h, w, forward=det_fwd)
            t2 = time.perf_counter()
            ocr.recognize_crops(opt, gt_crops, converter, recognizer)
            t3 = time.perf_counter()
            stages_ms.append(((t1 - t0) * 1e3, (t2 - t1 - (t1 - t0)) * 1e3,
                              (t3 - t2) * 1e3 / len(gt_crops)))
    finally:
        os.chdir(cwd)
    detect_ms, crop_ms, recognize_ms = np.median(stages_ms[1:], axis=0)
    if cv2.imread(os.path.join(workdir, "ocr.jpg")) is None:
        raise AssertionError("ocr: no output image")
    log(f"ocr ok: {len(texts)} crops exported in {export_s:.2f} s; "
        f"card vs CPU at batch {REC_BATCH}, full width "
        f"{json.dumps(REC_WIDTH)}: {json.dumps(rows)}; train steps at "
        f"batch {REC_TRAIN_BATCH} (median of the last "
        f"{REC_STEPS - 2}): {json.dumps(train_ms)}; train_rec 2 epochs "
        f"{train_rec_s:.2f} s; rec_bench rec {rec_s:.2f} s "
        f"{json.dumps(rec)}; e2e {e2e_s:.2f} s {json.dumps(e2e)}; cli.ocr "
        f"int8 on {os.path.basename(image)}: {len(results)} words, int8 "
        f"launches {json.dumps(i8)}; stages (median of 3 after one): "
        f"detect {detect_ms:.2f} ms, crop {crop_ms:.2f} ms, recognize "
        f"{recognize_ms:.2f} ms a crop, one forward each ({len(gt_crops)} "
        f"GT crops of the image); the phase took "
        f"{time.perf_counter() - t_phase:.2f} s")
    return i8


def fixture_input() -> np.ndarray:
    """The seeded input of the Flax fixture's maps
    (``tests/make_flax_fixture.fixture_input``)."""
    return np.random.RandomState(0).uniform(
        -120, 120, (1, 64, 64, 3)).astype(np.float32)


class Recorder:
    """Wraps ``fn`` and keeps each call's (args, result)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((args, out))
        return out


def tools_cli_test(workdir: str, pth: str) -> tuple[dict, dict]:
    """``cli/test`` on a synthetic 640x480 image at full width (the serve
    phase's .pth), in the three output modes, flax and int8, on the card
    and on the CPU; what each overlay is drawn from (``utils/visualize``'s
    ``overlay`` and ``filter_zero_boxes``, recorded) held card against CPU.
    Returns the rows and the int8 kernels' launches in the card's int8
    runs, by form."""
    import cv2

    from db_text_minimal_tpu_torch.cli import test as test_cli
    from db_text_minimal_tpu_torch.utils import visualize

    image = os.path.join(workdir, "tools_scene.png")
    with open(image, "wb") as f:
        f.write(synthetic_images()[0])
    real = visualize.overlay, visualize.filter_zero_boxes
    rows, i8 = {}, dict.fromkeys(I8.LAUNCHES, 0)
    try:
        for infer in ("flax", "int8"):
            for mode, flags in CLI_TEST_MODES:
                seen = {}
                for device in ("cuda", "cpu"):
                    drawn = visualize.overlay = Recorder(real[0])
                    boxes = visualize.filter_zero_boxes = Recorder(real[1])
                    args = test_cli.load_args(
                        ["--image_path", image, "--model_path", pth,
                         "--save_dir", os.path.join(workdir, "tools_out",
                                                    device),
                         "--infer_mode", infer, "--device", device,
                         "--thresh", "0.3", "--box_thresh", "0.5"] + flags)
                    reset_all_launches()
                    t0 = time.perf_counter()
                    path = test_cli.main(args)
                    wall = (time.perf_counter() - t0) * 1e3
                    if cv2.imread(path).shape != (480, 640, 3):
                        raise AssertionError(f"cli/test: {path}")
                    if device == "cuda":
                        launches = I8.LAUNCHES["int8_conv"]
                        if launches != (INT8_CONVS if infer == "int8"
                                        else 0):
                            raise AssertionError(
                                f"cli/test {infer} {mode}: the int8 conv "
                                f"launched {launches} times")
                        for key, value in I8.LAUNCHES.items():
                            i8[key] += value
                    layer = np.asarray(drawn.calls[0][0][1][0][0])
                    found = boxes.calls[0][1][0] if boxes.calls else []
                    seen[device] = (wall, layer, found)
                rows[f"{infer} {mode}"] = tools_compare(
                    f"cli/test {infer} {mode}", seen["cuda"], seen["cpu"],
                    mode)
    finally:
        visualize.overlay, visualize.filter_zero_boxes = real
    return rows, i8


def tools_compare(what: str, card, cpu, mode: str) -> dict:
    """A card run of cli/test against the CPU run: the binarized maps (the
    heatmap) agree on TOOLS_AGREE of the pixels; the resized prob maps lie
    within a mean TOOLS_GAP and the box counts within TOOLS_BOXES (or 2)
    of each other."""
    (wall, layer, boxes), (cpu_wall, cpu_layer, cpu_boxes) = card, cpu
    row = {"card_ms": wall, "cpu_ms": cpu_wall}
    if mode == "heatmap":
        row["agree"] = float((layer == cpu_layer).mean())
        if not row["agree"] >= TOOLS_AGREE:
            raise AssertionError(f"{what}: binarized maps agree on "
                                 f"{row['agree']}")
        return row
    row.update(gap=float(np.abs(layer - cpu_layer).mean()),
               boxes=len(boxes), cpu_boxes=len(cpu_boxes))
    if not (row["gap"] <= TOOLS_GAP and abs(len(boxes) - len(cpu_boxes))
            <= max(2, TOOLS_BOXES * len(cpu_boxes)) and len(cpu_boxes)):
        raise AssertionError(f"{what}: card against CPU {row}")
    return row


def tools_webcam(workdir: str, pth: str) -> dict:
    """``cli/webcam`` with recognition (the seeded full-width ResNet/Attn
    recognizer, its default) on a TOOLS_FRAMES-frame mp4v video of the
    synthetic 640x480 images, every frame processed; then each frame's
    ``process_frame`` timed."""
    import cv2

    from db_text_minimal_tpu_torch.cli import ocr, webcam
    from db_text_minimal_tpu_torch.postprocess import SegDetectorRepresenter

    video = os.path.join(workdir, "tools_in.mp4")
    out = os.path.join(workdir, "tools_out.mp4")
    frames = [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
              for b in synthetic_images()[:TOOLS_FRAMES]]
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 20.0,
                             (640, 480))
    for frame in frames:
        writer.write(frame)
    writer.release()
    args = webcam.load_args(["--det_model_path", pth, "--video_path", video,
                             "--out_path", out, "--per_frame", "1",
                             "--recognize", "--thresh", "0.3",
                             "--box_thresh", "0.5"])
    t0 = time.perf_counter()
    count = webcam.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cap = cv2.VideoCapture(out)
    written = 0
    while cap.read()[0]:
        written += 1
    cap.release()
    if not count == written == TOOLS_FRAMES:
        raise AssertionError(f"webcam: {count} frames read, {written} "
                             f"written of {TOOLS_FRAMES}")
    # the per-frame cost apart from loading the models
    _, forward = build_inference_forward(pth)
    converter = ocr.build_converter(args)
    rec = (converter, ocr.load_rec_model(args, len(converter.character)))
    seg = SegDetectorRepresenter(thresh=args.thresh,
                                 box_thresh=args.box_thresh,
                                 unclip_ratio=args.unclip_ratio)
    words = Recorder(webcam.recognize_crops)
    webcam.recognize_crops = words
    try:
        times = []
        for frame in frames + frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            webcam.process_frame(args, frame.copy(), forward, seg, rec)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        webcam.recognize_crops = words.fn
    ms = float(np.median(times[len(frames):]))
    return {"frames": count, "main_wall_s": wall,
            "main_frames_per_s": count / wall, "frame_ms": ms,
            "frames_per_s": 1e3 / ms,
            "words_a_frame": [len(out) for _, out in
                              words.calls[len(frames):]]}


def tools_pretrain(workdir: str) -> dict:
    """``pretrain_backbone_dense`` at full resnet18 width for
    PRETRAIN_STEPS steps of PRETRAIN_BATCH 128x128 crops of the quality
    set; its .pth loaded into a ``Trainer``; then ``build_step`` timed on
    the same sampler's batches."""
    from db_text_minimal_tpu_torch.train import backbone_pretrain as BP

    train_dir = os.path.join(workdir, "hard", "train_images")
    gt_dir = os.path.join(workdir, "hard", "train_gts")
    out = os.path.join(workdir, "tools_backbone.pth")
    t0 = time.perf_counter()
    result = BP.pretrain_backbone_dense(train_dir, gt_dir, out,
                                        steps=PRETRAIN_STEPS,
                                        batch_size=PRETRAIN_BATCH, log=log)
    wall = time.perf_counter() - t0
    cfg = default_config()
    cfg.model.pretrained_backbone_path = out
    cfg.logging.logger_file = None
    state = T.Trainer(cfg).init_state()
    saved = torch.load(out, weights_only=True)
    for key, value in state.model.backbone.state_dict().items():
        if not (key.endswith("num_batches_tracked")
                or torch.equal(value.cpu(), saved[key])):
            raise AssertionError(f"pretrain: the Trainer's {key} is not "
                                 f"the .pth's")
    images, bboxes = BP.load_scene_bboxes(train_dir, gt_dir)
    rng = np.random.RandomState(SEED)
    model = BP.BackboneDense()
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    step, _ = BP.build_step(model.cuda(), BP.dense_loss, torch.device("cuda"))
    times = []
    for _ in range(6):
        batch = BP.sample_patches_dense(images, bboxes, rng, PRETRAIN_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = step(2e-3, *batch)
        if not np.isfinite(float(loss)):
            raise AssertionError(f"pretrain: loss {loss}")
        times.append((time.perf_counter() - t0) * 1e3)
    return {**result, "wall_s": wall,
            "step_ms": float(np.median(times[2:]))}


def tools_train(workdir: str) -> tuple[dict, dict]:
    """``cli.train`` on the quality set (640x640, global batch 4, bf16)
    with ``--coordinator_address --num_processes 1 --process_id 0``: NCCL,
    the model in DistributedDataParallel; ``--profile_dir`` records the
    first
    epoch, then ``fit`` runs one more (in a group of one the model is in
    DDP, without the collectives of a larger group). K2 must launch in
    every step and the trace must name its Triton kernels. Then a bf16 step at batch 4 timed
    plain, in DDP (a group of one) and plain again. Returns the row and
    the K2 launches."""
    import socket

    from db_text_minimal_tpu_torch.cli import train as train_cli

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    root = os.path.join(workdir, "tools_train")
    hard = os.path.join(workdir, "hard")
    config = os.path.join(workdir, "tools_train.yaml")
    section = {"train_dir": f"{hard}/train_images",
               "train_gt_dir": f"{hard}/train_gts",
               "test_dir": f"{hard}/test_images",
               "test_gt_dir": f"{hard}/test_gts", "ignore_tags": ["###"]}
    with open(config, "w") as f:   # JSON is YAML
        json.dump({"meta": {"root_dir": root},
                   "dataset": {"name": "totaltext"},
                   "data": {"totaltext": section},
                   "hps": {"img_size": SIZE, "batch_size": TRAIN_BATCH,
                           "test_batch_size": 1}}, f)
    profile = os.path.join(root, "profile")
    reset_all_launches()
    t0 = time.perf_counter()
    _, history = train_cli.main(train_cli.load_args(
        ["--config", config, "--epochs", "1", "--coordinator_address",
         f"127.0.0.1:{free_port()}", "--num_processes", "1",
         "--process_id", "0", "--profile_dir", profile]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2 = {k: D.LAUNCHES[k] for k in ("db_step_forward", "db_step_backward")}
    steps = 2 * (QUALITY_TRAIN // TRAIN_BATCH)
    if not (k2["db_step_forward"] == k2["db_step_backward"] == steps
            and np.isfinite(history[0]["train_loss"])):
        raise AssertionError(f"cli.train DDP: K2 {k2} in {steps} steps, "
                             f"history {history}")
    if torch.distributed.is_initialized():
        raise AssertionError("cli.train left its process group")
    (trace,) = os.listdir(profile)
    with open(os.path.join(profile, trace)) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    named = {k: sum(k in n for n in names) for k in
             ("_db_step_fwd_kernel", "_db_step_bwd_kernel", "nccl")}
    if not (named["_db_step_fwd_kernel"] and named["_db_step_bwd_kernel"]):
        raise AssertionError(f"cli.train DDP: the trace names {named}")
    if not os.path.exists(os.path.join(root, "models", "last_cp.ckpt")):
        raise AssertionError("cli.train DDP: no last checkpoint")

    cfg = train_config(workdir, SIZE, TRAIN_BATCH, "cuda")
    batch = T.to_device(text_batch(SEED + 11, TRAIN_BATCH, SIZE),
                        torch.device("cuda"))

    def step_ms() -> float:
        state = T.Trainer(cfg).init_state()
        step = T.build_train_step(cfg)
        times = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch, LR)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[3:]))

    plain = step_ms()
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0)
    try:
        ddp = step_ms()
    finally:
        torch.distributed.destroy_process_group()
    return ({"wall_s": wall, "epochs": 2, "steps": steps, "history": history,
             "trace_names": named, "step_ms_plain": [plain, step_ms()],
             "step_ms_ddp": ddp}, k2)


def tools_dump(workdir: str) -> dict:
    """``quality_bench --eval_only --dump_eval_dir`` on the quality
    phase's checkpoint: each test batch's npz and boxes pickle, the
    device row through K3-K6."""
    import pickle

    dump = os.path.join(workdir, "tools_dump")
    reset_all_launches()
    quality_bench.main(quality_bench.load_args(
        ["--data_dir", os.path.join(workdir, "hard"), "--batch_size",
         str(QUALITY_BATCH), "--test_batch_size", str(QUALITY_BATCH),
         "--thresh", "0.25", "--box_thresh", "0.5", "--eval_only",
         "--checkpoint", os.path.join(workdir, "quality.ckpt"),
         "--dump_eval_dir", dump, "--out",
         os.path.join(workdir, "tools_dump.json")]))
    torch.cuda.synchronize()
    check_launches(all_launches(), RECT_PATH, "quality bench --dump_eval_dir")
    batches = QUALITY_TEST // QUALITY_BATCH
    want = sorted(f"batch_{i:03d}{ext}" for i in range(batches)
                  for ext in (".npz", ".boxes.pkl"))
    if sorted(os.listdir(dump)) != want:
        raise AssertionError(f"dump: {sorted(os.listdir(dump))}")
    preds = np.load(os.path.join(dump, "batch_000.npz"))["preds"]
    with open(os.path.join(dump, "batch_000.boxes.pkl"), "rb") as f:
        rows = pickle.load(f)
    if not (preds.shape == (QUALITY_BATCH, SIZE, SIZE, 2)
            and preds.dtype == np.float32 and np.isfinite(preds).all()
            and list(rows) == ["host", "device"]
            and all(len(rows[r][0]) == QUALITY_BATCH for r in rows)):
        raise AssertionError(f"dump: preds {preds.shape} {preds.dtype}, "
                             f"rows {list(rows)}")
    # rect mode's host rows keep a zero entry for each rejected contour
    return {"files": want, "boxes": {
        r: int(sum((np.abs(np.asarray(b, float)).sum() > 0) for img in
                   rows[r][0] for b in img)) for r in rows}}


def phase_tools(workdir: str, pth: str) -> dict:
    """The tools phase (see the module): the Flax fixture, cli/test,
    cli/webcam, backbone pretraining, the distributed cli.train and
    --dump_eval_dir. Returns the int8 kernels' launches in cli/test's int8
    runs and K2's in the distributed cli.train."""
    t_phase = time.perf_counter()
    model = load_model(FLAX_FIXTURE, dtype=torch.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(fixture_input()).cuda()).cpu().numpy()
    flax_gap = float(np.abs(got - np.load(FLAX_MAPS)).max())
    if not flax_gap <= FAMILY_TOL:
        raise AssertionError(f"Flax fixture: max abs {flax_gap} from the "
                             f"JAX maps")
    cli_rows, i8 = tools_cli_test(workdir, pth)
    webcam_row = tools_webcam(workdir, pth)
    pretrain_row = tools_pretrain(workdir)
    train_row, k2 = tools_train(workdir)
    dump_row = tools_dump(workdir)
    log(f"tools ok: the Flax fixture ({FLAX_FIXTURE}, the JAX package's "
        f"msgpack, narrow widths from its sidecar) in fp32 on the card, "
        f"max abs {flax_gap:.3g} from the JAX maps (tolerance "
        f"{FAMILY_TOL}); cli/test card against CPU, ms a call "
        f"(weights loaded each call) {json.dumps(cli_rows)}, int8 launches "
        f"{i8}; webcam {json.dumps(webcam_row)}; pretrain_backbone_dense "
        f"{json.dumps(pretrain_row)}; cli.train DDP "
        f"{json.dumps(train_row)}, K2 {json.dumps(k2)}; --dump_eval_dir "
        f"{json.dumps(dump_row)}; the phase took "
        f"{time.perf_counter() - t_phase:.2f} s")
    return {"i8": i8, "k2": k2}


def check_prf(what, loss, precision, recall, hmean) -> None:
    prf = (precision, recall, hmean)
    if not (np.isfinite(loss)
            and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in prf)):
        raise AssertionError(f"{what}: loss {loss}, P/R/F {prf}")


def phase_check_train(workdir: str) -> None:
    """One train step at 128², batch 2, on the card and on the CPU from the
    same seeded weights and batch, in the fp32 parity configuration, under
    both OHEM reductions: the five
    losses at rtol 1e-4, the BN statistics at atol 1e-5 + rtol 1e-4, and
    each gradient within a share of its leaf's max |g| (at least 1). cuDNN's
    and the CPU's f32 convolutions differ by ~1e-5 in P - T, which B̂ =
    σ(50(P - T)) multiplies by up to 12.5: 1e-3 under 'mean'. Under 'none'
    the top-k also takes or leaves the negatives whose loss lies within that
    noise of the k-th largest, each moving its pixel's whole BCE gradient:
    2e-2."""
    batch = text_batch(SEED + 7, 2, 128)
    for reduction, grad_tol in (("mean", 1e-3), ("none", 2e-2)):
        results = []
        for device in ("cuda", "cpu"):
            cfg = train_config(workdir, 128, 2, device, "float32")
            cfg.optimizer.reduction = reduction
            state = T.Trainer(cfg).init_state()
            state, loss, _, _ = T.build_train_step(cfg)(
                state, T.to_device(batch, torch.device(device)), LR)
            grads = {n: p.grad.cpu()
                     for n, p in state.model.named_parameters()}
            stats = {k: v.cpu() for k, v in state.model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            results.append(([float(v) for v in loss], grads, stats))
        (loss_c, grads_c, stats_c), (loss_h, grads_h, stats_h) = results
        np.testing.assert_allclose(loss_c, loss_h, rtol=1e-4)
        gaps = {k: (grads_c[k] - grads_h[k]).abs().max().item()
                / max(1.0, grads_h[k].abs().max().item()) for k in grads_h}
        worst = max(gaps, key=gaps.get)
        if not gaps[worst] <= grad_tol:
            raise AssertionError(f"{reduction}: gradient gap {gaps[worst]} "
                                 f"of {worst}'s max")
        worst_stat = 0.0
        for k in stats_h:
            torch.testing.assert_close(stats_c[k], stats_h[k], rtol=1e-4,
                                       atol=1e-5)
            worst_stat = max(worst_stat,
                             (stats_c[k] - stats_h[k]).abs().max().item())
        log(f"check ok: a train step ({reduction}) on the card vs the CPU "
            f"at 128x128, batch 2: losses {loss_c} vs {loss_h}; worst "
            f"gradient gap {gaps[worst]:.3g} of its leaf's max ({worst}, "
            f"tolerance {grad_tol}), worst BN statistic gap "
            f"{worst_stat:.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    try:
        phase_build()
        int8_rows = phase_int8_kernels()
        conv_rows = phase_int8_conv_kernels()
        rows = phase_kernels()
        phase_k3_sweep()
        phase_k5_sweep()
        poly_rows = phase_poly_kernels()
        phase_drivers()
        db_rows = phase_db_step_kernels()
        d1_rows = phase_deform_kernels()
        with tempfile.TemporaryDirectory() as workdir:
            launches, pth, preds, flax_ms = phase_serve(workdir)
            rows += phase_served(preds)
            quant = phase_quant(pth, flax_ms)
            phase_check_quant(preds, quant)
            i8_launches = quant["launches"]
            del quant
            phase_export(workdir, pth)
            phase_prune(workdir, pth)
            poly_launches = phase_polygon(preds)
            del preds
            train_launches = phase_train(workdir)
            families = phase_families(workdir)
            phase_check(pth)
            phase_check_polygon()
            phase_check_train(workdir)
            phase_quality(workdir)
            ocr_i8 = phase_ocr(workdir)
            tools = phase_tools(workdir, pth)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    for row in rows + poly_rows:
        kernel = row["name"].removesuffix("_served")
        if kernel == "fast_boxes":
            continue
        if KERNEL_IDS[kernel] == "K7":
            row["launches"] = poly_launches[COUNTER.get(kernel, kernel)]
            row["launches_in"] = f"polygon mode: one batch of {N} at 640x640"
        else:
            row["launches"] = launches[kernel]
            row["launches_in"] = f"serve, box mode: one batch of {N}"
    for row in db_rows:
        row["launches"] = train_launches[row["name"]]
        row["launches_ddp"] = tools["k2"].get(row["name"], 0)
        row["launches_in"] = f"train: {TRAIN_STEPS} steps"
    for row in int8_rows + conv_rows:
        counter = (f"int8_conv_{row['form']}" if "form" in row
                   else row["name"])
        row["launches"] = i8_launches[counter]
        row["launches_ocr"] = ocr_i8[counter]
        row["launches_cli_test"] = tools["i8"][counter]
        row["launches_in"] = (f"quant: the int8 handler's box and masks "
                              f"forwards and the static forward's, batch "
                              f"of {N} (the kernel's count in this form)")
    dr50 = "deformable_resnet50+FPN"
    for row in d1_rows:
        row["launches"] = families["d1_step"][dr50][row["name"]]
        row["launches_in"] = (f"families: one bf16 train step of "
                              f"{dr50} at batch {QUALITY_BATCH}")
        row["launches_served"] = {
            name: launches[row["name"]]
            for name, launches in families["served"].items()
            if name.startswith("deformable")}
    rows += poly_rows + db_rows + int8_rows + conv_rows + d1_rows
    for row in rows:
        row["id"] = ("P1 conv" if row["name"].startswith("int8_conv")
                     else KERNEL_IDS[row["name"]])
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
