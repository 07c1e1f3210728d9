#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU::

    python3 chip_smoke.py

Phases, one output line each (or more), stopping at the first failure:

1. build   - compile the CUDA kernels (csrc/cc.cu, nvcc sm_90a), the host
             geometry library and the Triton kernels K1 and K2
             (ops/db_step_triton.py), in parallel.
2. kernels - hold each kernel K3-K6 against its plain PyTorch version on the
             card at the serving path's shapes (8 prob maps of 640x640,
             K = 1000 slots), and K1, K2 forward and K2 backward at the
             training shapes (P and T of 4x1x640x640, the backward's
             gradient at the element stride of the NHWC output's last
             channel); time each and its plain version.
3. serve   - serve one batch of 8 synthetic 640x480 images through the
             port's handler in box mode: resnet18 + FPN (inner 256) +
             FusedDBHead, fp32, weights drawn from a seed and loaded from a
             .pth with the reference's key names. Every kernel's launch
             counter must rise. Then time the batch.
4. train   - the training configuration of the JAX package's defaults:
             resnet18 + FPN (inner 256) + DBHead in train mode, 640², batch
             4, fp32 with TF32 off, true per-pixel OHEM, Adam at lr 0.005.
             Twelve steps of Trainer.train_epoch on one synthetic batch
             (numpy scenes, GT maps in the compact layout); K2 forward and
             backward must launch once a step and the loss must fall. Then
             Trainer.eval_epoch in rect mode on two test images: K3-K6 must
             launch and P, R, F lie in [0, 1].
5. check   - device boxes against the host rect-mode SegDetectorRepresenter
             on synthetic scenes, the model on the card against the same
             model on the CPU, and one train step on the card against the
             same step on the CPU.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and as
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

from db_text_minimal_tpu_torch.config import default_config
from db_text_minimal_tpu_torch.data.scenes import text_batch
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.ops import cc, geometry
from db_text_minimal_tpu_torch.ops import db_step as D
from db_text_minimal_tpu_torch.postprocess import (DeviceBoxRepresenter,
                                                   SegDetectorRepresenter)
from db_text_minimal_tpu_torch.serve.handler import DBTextDetectionHandler
from db_text_minimal_tpu_torch.train import trainer as T

SEED = 0
N, SIZE, K = 8, 640, 1000
HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate
FP32_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit rate
SRC = "db_text_minimal_tpu_torch/csrc/cc.cu"
JAX_CC = "db_text_minimal_tpu/ops/pallas/cc.py"
TRITON_SRC = "db_text_minimal_tpu_torch/ops/db_step_triton.py"
JAX_DB_STEP = "db_text_minimal_tpu/ops/pallas/db_step.py"
TRAIN_BATCH, TRAIN_STEPS, LR = 4, 12, 0.005


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs after two
    warm-up runs, from CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, reps: int) -> tuple[float, dict]:
    """Device time of ``fn`` from torch.profiler: the card's activity
    (kernels, copies, fills) per call in ms, and ms per call by kernel
    name, over ``reps`` calls after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    return sum(by_name.values()), by_name


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
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(cc.load_library),
                pool.submit(geometry.load_library),
                pool.submit(build_triton)]
        for job in jobs:
            job.result()
    log(f"build ok: cc.cu (nvcc sm_90a), geometry.cpp (g++) and K1, K2 "
        f"forward and backward (Triton) in "
        f"{time.perf_counter() - t0:.2f} s")


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, route, source, replaces, err, tol, kernel, plain,
               bytes_moved, ops) -> dict:
    """Hold a kernel to its tolerance, time it and its plain version, and
    give its row of the kernels line (launches are filled in later).
    ``ms`` is the time per call of back-to-back calls from CUDA events,
    host launch cost included; ``device_ms`` the card's own activity per
    call, from torch.profiler."""
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    ms, plain_ms = timed(kernel, 20), timed(plain, 3)
    dev_ms, _ = device_kernels(kernel, 20)
    bound_ms, bound_by = bound(bytes_moved, ops)
    log(f"kernel {name}: max_abs_err {err} (tolerance {tol}), "
        f"{ms:.4f} ms, on the card {dev_ms:.4f} ms, plain {plain_ms:.3f} "
        f"ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": float(err),
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


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

    # K4: slots and valid roots exact (timed on the foreground labels; the
    # main path runs it on both label maps)
    keyed, valid_root = cc.compact_slots(labels, K)
    keyed_p, valid_root_p = cc.compact_slots_plain(labels, K)
    err = max((keyed - keyed_p).abs().max().item(),
              (valid_root ^ valid_root_p).sum().item())
    record("compact_slots", 114, err, 0,
           lambda: cc.compact_slots(labels, K),
           lambda: cc.compact_slots_plain(labels, K),
           px * (4 + 4) + N * K, px * 4)

    # K6, the route step alone on the background's slots: hole counts
    # exact; hole sums are f64 sums rounded to f32, so the kernel's atomic
    # order may move them by an ulp. It reads the mask and both slot maps
    # at every pixel and prob at the hole pixels only.
    bg_keyed, _ = cc.compact_slots(bg_labels, K)
    hole = cc.hole_stats(mask, keyed, bg_keyed, prob, K)
    hole_p = cc.hole_stats_plain(mask, keyed, bg_keyed, prob, K)
    if not torch.equal(hole[1], hole_p[1]):
        raise AssertionError("hole_stats: hole counts differ")
    err = (hole[0] - hole_p[0]).abs().max().item()
    tol = 1e-6 * max(1.0, hole_p[0].abs().max().item())
    hole_px = int(hole_p[1].sum().item())
    bg_px = int((~mask).sum().item())
    record("hole_stats", 383, err, tol,
           lambda: cc.hole_stats(mask, keyed, bg_keyed, prob, K),
           lambda: cc.hole_stats_plain(mask, keyed, bg_keyed, prob, K),
           px * (1 + 4 + 4) + hole_px * 4 + N * K * 8, bg_px * 8 + px)

    # K5: valid exact; corners/sides within 1e-3 px and scores within 1e-6,
    # for the same f64-sum reason; the angle picks match the plain version
    out = cc.rotated_boxes(prob, keyed, valid_root, *hole, K)
    out_p = cc.rotated_boxes_plain(prob, keyed, valid_root, *hole_p, K)
    valid = out_p[3]
    if not torch.equal(out[3], valid):
        raise AssertionError("rotated_boxes: valid slots differ")
    err = max((out[0] - out_p[0])[valid].abs().max().item(),
              (out[1] - out_p[1])[valid].abs().max().item())
    score_err = (out[2] - out_p[2]).abs().max().item()
    if score_err > 1e-6:
        raise AssertionError(f"rotated_boxes: score error {score_err}")
    fg_px = int((keyed < K).sum().item())
    candidates = sum(len(o) for o in cc.stage_offsets())
    record("rotated_boxes", 184, err, 1e-3,
           lambda: cc.rotated_boxes(prob, keyed, valid_root, *hole, K),
           lambda: cc.rotated_boxes_plain(prob, keyed, valid_root, *hole_p,
                                          K),
           px * (4 + 4) + N * K * 54,
           fg_px * (12 + candidates * 10))
    log(f"kernels ok: {int(valid.sum())} valid components over {N} maps "
        f"of {SIZE}x{SIZE}, {fg_px} foreground pixels")
    return rows


def phase_db_step_kernels() -> list[dict]:
    """K1, K2 forward and K2 backward at the training shapes. B̂ within
    1e-6 (the kernels' exp is the card's fast one), the bitmap exact, dP
    and dT within 1e-6 of max(1, max|g|). Bytes: K1 reads P, T and writes
    B̂ and the bitmap, 16 B a pixel; K2 forward 12 B; K2 backward reads g
    and B̂ and writes dP and dT, 16 B."""
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
    rows.append(kernel_row(
        "db_step_backward", "triton", TRITON_SRC, f"{JAX_DB_STEP}:114",
        err, 1e-6 * max(1.0, grad.abs().max().item()),
        lambda: D.db_step_backward(grad, bhat),
        lambda: D.db_step_backward_plain(grad, bhat), px * 16, px * 5))
    log(f"db step kernels ok at {TRAIN_BATCH}x1x{SIZE}x{SIZE}; the "
        f"backward's gradient has element stride "
        f"{D.uniform_stride(grad)}")
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


def phase_serve(workdir: str) -> tuple[dict, str]:
    model = DBTextModel()
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    pth = os.path.join(workdir, "dbnet_resnet18_seed.pth")
    torch.save(model.state_dict(), pth)
    handler = DBTextDetectionHandler(pth)         # CUDA, FusedDBHead
    handler.initialize()
    request = [{"body": b} for b in synthetic_images()]

    cc.reset_launches()
    result = handler.handle(request, mode="boxes")
    torch.cuda.synchronize()
    launches = dict(cc.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if len(result) != N:
        raise AssertionError(f"{len(result)} results for {N} images")
    for r in result:
        boxes = np.asarray(r["boxes"], float).reshape(-1, 4, 2)
        if len(boxes) != len(r["scores"]) or not np.isfinite(boxes).all():
            raise AssertionError(f"malformed box result {r}")
    log(f"serve ok: batch of {N} in box mode, boxes per image "
        f"{[len(r['boxes']) for r in result]}, launches {launches}")

    # host stages vary from call to call on a shared host: time each batch
    # and report the median and the quartiles of the per-batch times
    reps = 11
    stages = {"preprocess": [], "forward": [], "postprocess_boxes": [],
              "total": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch = handler.preprocess(request)
        t1 = time.perf_counter()
        preds = handler.inference(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        handler.postprocess_boxes(preds)
        t3 = time.perf_counter()
        for name, dt in (("preprocess", t1 - t0), ("forward", t2 - t1),
                         ("postprocess_boxes", t3 - t2), ("total", t3 - t0)):
            stages[name].append(dt * 1e3)
    quartiles = {k: [float(q) for q in np.percentile(v, [25, 50, 75])]
                 for k, v in stages.items()}
    log(f"serve timing: {N * 1e3 / quartiles['total'][1]:.2f} img/s at batch "
        f"{N}, fp32, 640x640 (median of {reps} batches); per batch ms "
        f"[q25, median, q75] {json.dumps(quartiles)}")
    return launches, pth


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

    # the model on the card against the same weights on the CPU; fp32 with
    # TF32 off, so only summation order differs
    from db_text_minimal_tpu_torch.cli.common import load_model

    x = torch.from_numpy(np.random.RandomState(SEED).rand(2, 64, 64, 3)
                         .astype(np.float32) * 2 - 1)
    with torch.inference_mode():
        on_card = load_model(pth, fuse_head=True)(x.to(dev)).cpu()
        on_cpu = load_model(pth, device="cpu", fuse_head=True)(x)
    err = (on_card - on_cpu).abs().max().item()
    if not (torch.isfinite(on_card).all() and err < 1e-4):
        raise AssertionError(f"model on card vs CPU: max_abs_err {err}")
    log(f"check ok: model on the card vs the CPU, max_abs_err {err:.3g} "
        f"(tolerance 1e-4)")


def train_config(workdir: str, size: int, batch: int, device: str):
    cfg = default_config()
    cfg.meta.device = device
    cfg.meta.root_dir = workdir
    cfg.hps.img_size = size
    cfg.hps.batch_size = batch
    cfg.logging.logger_file = None
    cfg.metric.is_output_polygon = False     # rect-mode eval, on K3-K6
    return cfg


def phase_train(workdir: str) -> dict:
    cfg = train_config(workdir, SIZE, TRAIN_BATCH, "cuda")
    batch = text_batch(SEED, TRAIN_BATCH, SIZE)
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
    D.reset_launches()
    state, _, _, _ = trainer.train_epoch(state, 0)
    events.append(torch.cuda.Event(enable_timing=True))
    events[-1].record()
    torch.cuda.synchronize()
    launches = dict(D.LAUNCHES)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    totals = [row["total_loss"] for row in trainer.loss_log]
    if not all(np.isfinite(v) for row in trainer.loss_log
               for v in row.values()):
        raise AssertionError(f"a loss is not finite: {trainer.loss_log}")
    if len(totals) != TRAIN_STEPS or not np.mean(totals[-3:]) < totals[0]:
        raise AssertionError(f"the loss did not fall: {totals}")
    if not (launches["db_step_forward"] == launches["db_step_backward"]
            == TRAIN_STEPS and launches["fused_db_step"] == 0):
        raise AssertionError(f"K2 launches {launches} in {TRAIN_STEPS} "
                             f"steps")
    q25, med, q75 = (float(q) for q in np.percentile(step_ms[2:],
                                                     [25, 50, 75]))
    log(f"train ok: {TRAIN_STEPS} steps of batch {TRAIN_BATCH} at "
        f"{SIZE}x{SIZE}, total loss {totals[0]:.4f} -> "
        f"{np.mean(totals[-3:]):.4f} (mean of the last 3); K2 launches "
        f"{launches['db_step_forward']} forward, "
        f"{launches['db_step_backward']} backward")
    log(f"train timing: ms per step over the last 10 steps [q25, median, "
        f"q75] [{q25:.3f}, {med:.3f}, {q75:.3f}], "
        f"{TRAIN_BATCH * 1e3 / med:.2f} img/s; all steps ms "
        f"{json.dumps([round(v, 3) for v in step_ms])}")

    # three more steps under the profiler: the card's busy time per step
    # and the kernels that take it
    step = T.build_train_step(cfg)
    device_batch = T.to_device(batch, torch.device("cuda"))
    busy_ms, by_name = device_kernels(
        lambda: step(state, device_batch, LR), 3)
    k2_ms = sum(v for k, v in by_name.items() if "_db_step_" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"train profile: the card busy {busy_ms:.3f} ms per step "
        f"({100 * busy_ms / med:.2f} % of the median step; idle "
        f"{100 * (1 - busy_ms / med):.2f} %); K2 forward + backward "
        f"{k2_ms:.4f} ms = {100 * k2_ms / med:.4f} % of the step; top "
        f"kernels ms per step "
        f"{json.dumps({k[:60]: round(v, 4) for k, v in top})}")

    cc.reset_launches()
    test_loss, _, recall, precision, hmean = trainer.eval_epoch(state)
    torch.cuda.synchronize()
    eval_launches = dict(cc.LAUNCHES)
    missing = [k for k, v in eval_launches.items() if v == 0]
    if missing:
        raise AssertionError(f"eval never launched {missing}")
    prf = (precision, recall, hmean)
    if not (np.isfinite(test_loss)
            and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in prf)):
        raise AssertionError(f"eval: test loss {test_loss}, P/R/F {prf}")
    log(f"train eval ok: rect mode on 2 images, test loss {test_loss:.4f}, "
        f"P {precision:.4f} R {recall:.4f} F {hmean:.4f}, launches "
        f"{eval_launches}")
    return launches


def phase_check_train(workdir: str) -> None:
    """One train step at 128², batch 2, on the card and on the CPU from the
    same seeded weights and batch, under both OHEM reductions: the five
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
            cfg = train_config(workdir, 128, 2, device)
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
        rows = phase_kernels()
        db_rows = phase_db_step_kernels()
        with tempfile.TemporaryDirectory() as workdir:
            launches, pth = phase_serve(workdir)
            train_launches = phase_train(workdir)
            phase_check(pth)
            phase_check_train(workdir)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_in"] = f"serve: one batch of {N}"
    for row in db_rows:
        row["launches"] = train_launches[row["name"]]
        row["launches_in"] = f"train: {TRAIN_STEPS} steps"
    rows += db_rows
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
