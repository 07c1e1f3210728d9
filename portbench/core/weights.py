"""Seeded weights of a configuration, made on the device.

One ``torch.randn`` on the device draws every random value at once from a
generator seeded by ``--seed``; each kernel takes its slice, scaled as the
reference repository initialises it (Kaiming-normal over fan-out, with a
relu gain; conv and deconv biases zero; norms' weight 1 and bias 0, 1e-4 in
the DB head; running mean 0 and variance 1). A deformable conv's offset
branch keeps the reference's zero kernel, and its bias is drawn with the
standard deviation ``dcn_offset_std_px`` of the configuration: each tap
samples at a fractional shift of a few pixels, the same at every position,
as a trained model's offsets are of that size (the zero init has none). An
offset kernel drawn at random instead would make the offsets of seeded,
rough features so sensitive to their input that a rounding difference
grows about tenfold through each deformable block.

A served configuration's prob map is shaped in two more steps, so that it
looks as a trained model's does (smooth, confident, a tenth or so of the
pixels set, in blobs where the image has strokes and edges) and the box
postprocess has boxes to find: ``smooth_head`` gives each of the prob
branch's two deconvs one kernel for its four taps (a random kernel per tap
tiles the map with a fixed 4 × 4 pattern, which joins every set pixel into
one component), and ``calibrate_head`` scales its last deconv and sets its
bias from the cell's own images, as the norms' statistics are calibrated,
so that every seed serves about as many boxes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import model as M


def make(cfg: dict, seed: int, device) -> dict:
    """name -> float32 tensor on ``device`` (the norms' step counter an
    int64 0-d tensor), for every entry of ``reference.model.param_spec``."""
    spec = M.param_spec(cfg)
    random_kinds = ("conv", "deconv", "offset_bias")
    total = sum(math.prod(s) for _, s, k in spec if k in random_kinds)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    noise = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind in random_kinds:
            n = math.prod(shape)
            if kind == "conv":
                fan = shape[0] * shape[2] * shape[3]
                std = math.sqrt(2.0 / fan)
            elif kind == "deconv":
                fan = shape[1] * shape[2] * shape[3]
                std = math.sqrt(2.0 / fan)
            else:
                std = cfg["dcn_offset_std_px"]
            out[name] = (noise[at:at + n] * std).view(shape)
            at += n
        elif kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            value = {"bias": 0.0, "offset_weight": 0.0, "bn_weight": 1.0,
                     "bn_mean": 0.0, "bn_var": 1.0}.get(kind)
            if kind == "bn_bias":
                value = 1e-4 if name.startswith("segmentation_head.") \
                    else 0.0
            out[name] = torch.full(shape, value, device=device)
    return out


@torch.no_grad()
def calibrate_bn(weights: dict, cfg: dict, x: torch.Tensor) -> dict:
    """``weights`` with every norm's running mean set to its batch mean and
    its running variance to its biased batch variance plus 1, over one
    train-mode float32 forward of ``x`` (N, 3, H, W) by the reference, so
    that a seeded deep network's activations stay of order 1 in eval mode,
    as a trained one's do."""
    ops = M.Ops("calibrate")
    M.forward(weights, x, cfg, ops, train=False)
    out = dict(weights)
    for name, (mean, var) in ops.stats.items():
        out[f"{name}.running_mean"] = mean.clone()
        out[f"{name}.running_var"] = var + 1.0
    return out


PROB_BRANCH = "segmentation_head.binarize"
# the standardised logit's scales searched, and the bisection's steps
SCALE_RANGE = (0.25, 64.0)
SCALE_STEPS = 16


def smooth_head(weights: dict) -> dict:
    """``weights`` with each deconv of the prob branch using its top-left
    tap's kernel at all four taps."""
    out = dict(weights)
    for i in (3, 6):
        w = weights[f"{PROB_BRANCH}.{i}.weight"]
        out[f"{PROB_BRANCH}.{i}.weight"] = \
            w[:, :, :1, :1].expand_as(w).contiguous()
    return out


def _candidate_count(z: np.ndarray, cut: float, pp: dict):
    """A function of the logit's scale ``S`` that counts the candidates an
    image, on average, that the box postprocess would keep from the maps
    σ(S · (z − cut) + logit(thresh)) of the standardised logits ``z`` (N,
    H, W): 8-connected components of z > cut (the pixels above the
    threshold, whatever ``S``) whose bounding box spans ``min_size`` + 1
    pixels each way and whose mean probability reaches ``box_thresh``."""
    from scipy import ndimage

    plane = np.zeros((3, 3, 3), bool)
    plane[1] = True
    mask = z > cut
    labels, n = ndimage.label(mask, structure=plane)
    spans = ndimage.find_objects(labels)
    big = np.array([s[1].stop - s[1].start > pp["min_size"]
                    and s[2].stop - s[2].start > pp["min_size"]
                    for s in spans], bool)
    flat = labels[mask]
    size = np.bincount(flat, minlength=n + 1)[1:]
    inside = z[mask] - cut
    bias = math.log(pp["thresh"] / (1.0 - pp["thresh"]))

    def count(scale: float) -> float:
        prob = 1.0 / (1.0 + np.exp(-(scale * inside + bias)))
        mean = np.bincount(flat, prob, minlength=n + 1)[1:] / size
        return float(np.sum(big & (mean >= pp["box_thresh"]))) / len(z)

    return count


@torch.no_grad()
def calibrate_head(weights: dict, cfg: dict, x: torch.Tensor) -> dict:
    """``weights`` with the prob branch's last deconv rescaled and its bias
    set, over one eval-mode float32 forward of ``x`` by the reference: the
    pixels above the postprocess threshold are the share
    ``serve_map.set_share`` of the batch, and the logit's scale is found
    by bisection so that the postprocess keeps about
    ``serve_map.candidates_per_frame`` candidates an image (a trained model
    serves a box a word). The count is monotone in the scale: every pixel
    of a candidate lies above the cut, where a larger scale raises its
    probability."""
    target = cfg["serve_map"]
    pp = cfg["postprocess"]
    prob = M.forward(weights, x, cfg, M.Ops("eval"), prob_only=True)[:, 0]
    logit = torch.logit(prob.double())
    mean, std = float(logit.mean()), float(logit.std())
    z = ((logit - mean) / std).float().cpu().numpy()
    rank = int(round((1.0 - target["set_share"]) * z.size))
    cut = float(np.partition(z.ravel(), max(rank, 1) - 1)[max(rank, 1) - 1])
    count = _candidate_count(z, cut, pp)
    lo, hi = SCALE_RANGE
    for _ in range(SCALE_STEPS):
        mid = math.sqrt(lo * hi)
        if count(mid) < target["candidates_per_frame"]:
            lo = mid
        else:
            hi = mid
    scale = math.sqrt(lo * hi) / std
    out = dict(weights)
    name = f"{PROB_BRANCH}.6"
    out[f"{name}.weight"] = weights[f"{name}.weight"] * scale
    out[f"{name}.bias"] = ((weights[f"{name}.bias"] - mean - cut * std)
                           * scale
                           + math.log(pp["thresh"] / (1.0 - pp["thresh"]))
                           ).float()
    return out
