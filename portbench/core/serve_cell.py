"""Traffic kind ``serve``: one caller, closed loop, over the port's serving
handler in box mode without the decode.

Set-up makes the seeded weights, smooths the prob branch's deconvs
(``weights.smooth_head``), calibrates the norms' running statistics and
then the prob branch's output on pool batch 0 (``weights.calibrate_bn``,
``weights.calibrate_head``), writes them as a ``.pth`` in
the reference's key layout under ``TMPDIR`` and starts
``serve.handler.DBTextDetectionHandler`` on it in the configuration's
``serve_infer_mode``. A call hands a decoded uint8 batch to
``handler.inference(batch, prob_only=True)`` and its maps to
``handler.postprocess_boxes``, which returns the boxes on the host: what
``handle(request, mode="boxes")`` does after its decode. The latency of a
call runs from the hand-off to the boxes.

The check keeps, for each pool batch, the served prob maps and boxes of
one call drawn from the seed (its occurrence among that batch's calls).
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from ..reference import model as M
from ..reference import postprocess as RP
from . import compare, trace
from . import traffic as traffic_gen
from . import weights as W
from .train_cell import CAFFE_MEAN, free

MAX_OCCURRENCE = 8
# images of a batch in one block of the reference's forward (memory only)
REFERENCE_BLOCK = 8


class ProgramServer:
    """The port's handler on the benchmark's weights."""

    def __init__(self, cfg: dict, traffic: dict, weights: dict, device,
                 infer_mode: str | None = None):
        from db_text_minimal_tpu_torch.serve.handler import \
            DBTextDetectionHandler

        fd, path = tempfile.mkstemp(suffix=".pth")
        os.close(fd)
        try:
            torch.save({k: v.cpu() for k, v in weights.items()}, path)
            self.handler = DBTextDetectionHandler(
                path, infer_mode=infer_mode or cfg["serve_infer_mode"],
                device=str(device))
            self.handler.initialize()
        finally:
            os.unlink(path)

    def call(self, batch: np.ndarray):
        with trace.span("inference"):
            preds = self.handler.inference(batch, prob_only=True)
        with trace.span("postprocess_boxes"):
            out = self.handler.postprocess_boxes(preds)
        return preds, out


def reference_input(batch: np.ndarray, device) -> torch.Tensor:
    from ..reference import train as RT

    return RT.images_to_input(torch.from_numpy(batch).to(device), CAFFE_MEAN)


def serve_weights(cfg: dict, seed: int, batch: np.ndarray, device) -> dict:
    """The seeded weights of a serving cell, calibrated on ``batch``."""
    x = reference_input(batch, device)
    weights = W.calibrate_bn(W.smooth_head(W.make(cfg, seed, device)), cfg,
                             x)
    return W.calibrate_head(weights, cfg, x)


def served_boxes(out: list) -> list:
    return [(np.asarray(r["boxes"], np.float64).reshape(-1, 4, 2),
             np.asarray(r["scores"], np.float64)) for r in out]


def calls(server, pool: list, first: int, until=None,
          count: int | None = None, keep: dict | None = None) -> dict:
    """Closed-loop calls over ``pool`` from batch ``first``; per call its
    latency. ``keep`` maps a pool index to the occurrence whose output is
    kept for the check."""
    lat, kept, seen = [], {}, {}
    n = failed = 0
    while (count is not None and n < count) or (count is None and until()):
        j = (first + n) % len(pool)
        t0 = time.perf_counter()
        preds, out = server.call(pool[j])
        lat.append(time.perf_counter() - t0)
        failed += len(out) != len(pool[j])
        occurrence = seen.get(j, 0)
        seen[j] = occurrence + 1
        if keep is not None and keep.get(j) == occurrence:
            kept[j] = (preds[..., 0], out)
        n += 1
    return {"latencies": lat, "failed": failed, "kept": kept}


def sample(seed: int, n_pool: int) -> dict:
    from .scenes import rng_for

    rng = rng_for(seed, 3)
    return {j: int(rng.randint(MAX_OCCURRENCE)) for j in range(n_pool)}


@torch.no_grad()
def reference_maps(cfg: dict, weights: dict, batch: np.ndarray,
                   device) -> torch.Tensor:
    """The reference's float32 prob maps (N, H, W) of a uint8 batch, in
    blocks of ``REFERENCE_BLOCK`` rows."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for i in range(0, len(batch), REFERENCE_BLOCK):
        x = reference_input(batch[i:i + REFERENCE_BLOCK], device)
        out.append(M.forward(weights, x, cfg, M.Ops("eval"),
                             prob_only=True)[:, 0])
    return torch.cat(out)


def serve_readings(cfg: dict, weights: dict, pool: list, kept: dict,
                   device) -> dict:
    """The serving numbers (``compare``) of the kept calls, with the
    share of pixels above the threshold (``set_share``)."""
    gap = set_px = 0.0
    n_pix = 0
    served, ref = [], []
    for j, (prob, out) in sorted(kept.items()):
        prob = prob.float()
        want = reference_maps(cfg, weights, pool[j], device)
        gap += float((prob - want).abs().double().sum())
        set_px += float((prob > cfg["postprocess"]["thresh"]).sum())
        n_pix += prob.numel()
        served += served_boxes(out)
        ref += [RP.boxes(m, cfg["postprocess"]) for m in prob.cpu().numpy()]
    numbers = compare.box_readings(served, ref)
    numbers.update(prob_gap=gap / n_pix, set_share=set_px / n_pix)
    return numbers


def run(ctx) -> dict:
    cfg, traffic, device = ctx.config, ctx.traffic, ctx.device
    ctx.mark("start")
    pool = traffic_gen.make_pool(traffic, ctx.seed, ctx.workers)
    ctx.mark("traffic")
    weights = serve_weights(cfg, ctx.seed, pool[0], device)
    ctx.mark("weights")
    server = ctx.program_factory(cfg, traffic, weights, device)
    ctx.mark("program")
    warm = traffic["warmup_calls"]
    calls(server, pool, 0, count=warm)
    ctx.mark("warmup")
    keep = sample(ctx.seed, len(pool))

    t0 = time.perf_counter()
    setup_s = time.time() - ctx.t_start
    res = calls(server, pool, warm,
                until=lambda: time.perf_counter() - t0 < ctx.seconds,
                keep=keep)
    window_s = time.perf_counter() - t0
    memory = ctx.memory_peak()
    n = len(res["latencies"])
    lat_ms = 1e3 * np.asarray(res["latencies"])
    batch = traffic["batch"]
    out = {"attempted": n, "failed": res["failed"],
           "memory_peak_bytes": memory,
           "end_to_end": {"serve_img_per_s": n * batch / window_s,
                          "serve_p95_ms": float(np.percentile(lat_ms, 95)),
                          "setup_s": setup_s},
           "window": {"units": n, "seconds": window_s}}
    kept = res["kept"]
    missing = [j for j in keep if j not in kept]
    if missing:
        # a window too short to reach a sampled occurrence: the check
        # takes the batch's first call after it
        extra = calls(server, pool, missing[0], count=len(pool),
                      keep={j: 0 for j in missing})
        kept.update(extra["kept"])
    if ctx.trace:
        units = traffic["profile_calls"]
        info = ctx.trace_info(units=n, window_s=window_s)

        def profiled():
            calls(server, pool, warm + n, count=units)
            if device.type == "cuda":
                torch.cuda.synchronize()

        out["view"] = trace.profile(profiled, units, info)
    del server
    free()
    out["numbers"] = serve_readings(cfg, weights, pool, kept, device)
    out["details"] = {}
    return out
