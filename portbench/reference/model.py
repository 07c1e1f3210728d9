"""Plain PyTorch DBNet: ResNet-18 or deformable ResNet-50 (DCNv1 in the
conv2 of layer2..layer4), FPN (inner 256), DB head; float32, NCHW.

Written from DBNet (arXiv:1911.08947) and the reference repository's layout
(huyhoang17/DB_text_minimal: torchvision ResNet names, ``DBHead`` branches
as ``nn.Sequential`` indices 0/1/3/4/6), with no code of the measured
program. Weights are a dict of tensors under those names. Every operation
goes through an ``Ops`` object, so that one forward serves as the float32
reference (``Ops``), as the lower-precision control (``Int8Ops``: every
conv computed in int8 at per-tensor scales; ``Fp8Ops`` in float8, e4m3
going forward and e5m2 going back), and as the operation counter
(``flops.CountOps``).

Semantics held to the program's configuration:
- batch norm: eps 1e-5; in ``train`` mode the batch mean and biased
  variance; in ``eval`` mode the running statistics; ``calibrate`` mode is
  train mode that records each norm's batch mean and biased variance;
- the deformable conv: 18 offset channels, tap ``t = 3·ky + kx`` at
  channels (2t, 2t+1) = (dy, dx); tap (ky, kx) of output (i, j) samples the
  input at (i·s + ky − 1 + dy, j·s + kx − 1 + dx) bilinearly, each corner
  outside the image reading zero; the offset conv is a biased 3×3 conv at
  the block's stride;
- FPN: nearest upsampling by whole factors; the head's output
  P = σ(z_b), T = σ(z_t) and, in train mode, B̂ = σ(50 · (P − T)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
K_STEP = 50.0
BN_KEYS = ("weight", "bias", "running_mean", "running_var",
           "num_batches_tracked")

ARCHS = {
    "resnet18": {"block": "basic", "layers": (2, 2, 2, 2), "dcn": False},
    "deformable_resnet50": {"block": "bottleneck", "layers": (3, 4, 6, 3),
                            "dcn": True},
}


def _expansion(arch: dict) -> int:
    return 4 if arch["block"] == "bottleneck" else 1


def _blocks(arch: dict):
    """(stage, index, prefix, in_planes, planes, stride, downsample) of
    every residual block in order."""
    in_planes = 64
    exp = _expansion(arch)
    for s, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                        arch["layers"])):
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            out = planes * exp
            down = b == 0 and (stride != 1 or in_planes != out)
            yield s, b, f"backbone.layer{s + 1}.{b}", in_planes, planes, \
                stride, down
            in_planes = out


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight and buffer of the configuration,
    kinds: conv, deconv, bias, bn_weight, bn_bias, bn_mean, bn_var,
    bn_count, offset_weight, offset_bias."""
    arch = ARCHS[cfg["backbone"]]
    spec: list = []

    def conv(name, cout, cin, k, bias=False):
        spec.append((f"{name}.weight", (cout, cin, k, k), "conv"))
        if bias:
            spec.append((f"{name}.bias", (cout,), "bias"))

    def bn(name, c):
        for key, kind in zip(BN_KEYS, ("bn_weight", "bn_bias", "bn_mean",
                                       "bn_var", "bn_count")):
            spec.append((f"{name}.{key}", () if kind == "bn_count" else (c,),
                         kind))

    conv("backbone.conv1", 64, 3, 7)
    bn("backbone.bn1", 64)
    exp = _expansion(arch)
    for s, _, p, cin, planes, _, down in _blocks(arch):
        dcn = arch["dcn"] and s > 0
        if arch["block"] == "basic":
            conv(f"{p}.conv1", planes, cin, 3)
            bn(f"{p}.bn1", planes)
            mid_in = planes
        else:
            conv(f"{p}.conv1", planes, cin, 1)
            bn(f"{p}.bn1", planes)
            mid_in = planes
        spec.append((f"{p}.conv2.weight", (planes, mid_in, 3, 3), "conv"))
        if dcn:
            spec.append((f"{p}.conv2.offset_conv.weight", (18, mid_in, 3, 3),
                         "offset_weight"))
            spec.append((f"{p}.conv2.offset_conv.bias", (18,),
                         "offset_bias"))
        bn(f"{p}.bn2", planes)
        if arch["block"] == "bottleneck":
            conv(f"{p}.conv3", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
        if down:
            conv(f"{p}.downsample.0", planes * exp, cin, 1)
            bn(f"{p}.downsample.1", planes * exp)
    widths = [c * exp for c in (64, 128, 256, 512)]
    inner = cfg["fpn_inner_channels"]
    q = inner // 4
    for i, c in zip((2, 3, 4, 5), widths):
        conv(f"segmentation_body.reduce_conv_c{i}.conv", q, c, 1, bias=True)
        bn(f"segmentation_body.reduce_conv_c{i}.bn", q)
    for i in (4, 3, 2):
        conv(f"segmentation_body.smooth_p{i}.conv", q, q, 3, bias=True)
        bn(f"segmentation_body.smooth_p{i}.bn", q)
    conv("segmentation_body.conv.0", inner, 4 * q, 3, bias=True)
    bn("segmentation_body.conv.1", inner)
    width = cfg["head_width"]
    for branch in ("binarize", "thresh"):
        h = f"segmentation_head.{branch}"
        conv(f"{h}.0", width, inner, 3, bias=branch == "binarize")
        bn(f"{h}.1", width)
        spec.append((f"{h}.3.weight", (width, width, 2, 2), "deconv"))
        spec.append((f"{h}.3.bias", (width,), "bias"))
        bn(f"{h}.4", width)
        spec.append((f"{h}.6.weight", (width, 1, 2, 2), "deconv"))
        spec.append((f"{h}.6.bias", (1,), "bias"))
    return spec


class Ops:
    """Float32 operations of the reference. ``bn_mode`` is ``train``,
    ``eval`` or ``calibrate``; ``stats`` collects calibrate mode's
    per-norm (mean, biased variance)."""

    def __init__(self, bn_mode: str = "train"):
        self.bn_mode = bn_mode
        self.stats: dict = {}

    def conv(self, x, w, b=None, stride=1, pad=0):
        return F.conv2d(x, w, b, stride, pad)

    def deconv(self, x, w, b):
        return F.conv_transpose2d(x, w, b, stride=2)

    def bn(self, x, p: dict, name: str):
        g, b = p[f"{name}.weight"], p[f"{name}.bias"]
        if self.bn_mode == "eval":
            mean = p[f"{name}.running_mean"]
            var = p[f"{name}.running_var"]
        else:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            if self.bn_mode == "calibrate":
                self.stats[name] = (mean.detach(), var.detach())
        scale = g * torch.rsqrt(var + BN_EPS)
        return x * scale[:, None, None] + (b - mean * scale)[:, None, None]

    def deform(self, x, offsets, w, stride):
        return deform_conv(x, offsets, w, stride)


def _bilinear(flat, n, h, w, y, x):
    """(N, OH, OW, C) samples of the (N·H·W, C) rows ``flat`` at float
    coordinates (y, x), each (N, OH, OW); corners outside read zero."""
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = (y - y0)[..., None], (x - x0)[..., None]
    base = (torch.arange(n, device=flat.device) * (h * w))[:, None, None]
    out = 0.0
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy, xx = y0 + dy, x0 + dx
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = base + yy.clamp(0, h - 1).long() * w + xx.clamp(0, w - 1).long()
        vals = flat[idx.reshape(-1)].reshape(*idx.shape, -1)
        out = out + torch.where(ok[..., None], vals, 0.0) * wgt
    return out


def deform_conv(x, offsets, w, stride):
    """DCNv1 3×3, padding 1: x (N, C, H, W), offsets (N, 18, OH, OW), w
    (F, C, 3, 3) -> (N, F, OH, OW)."""
    n, c, h, wd = x.shape
    oh, ow = offsets.shape[-2:]
    flat = x.permute(0, 2, 3, 1).reshape(n * h * wd, c)
    rows = torch.arange(oh, device=x.device, dtype=x.dtype) * stride
    cols = torch.arange(ow, device=x.device, dtype=x.dtype) * stride
    out = 0.0
    for t in range(9):
        ky, kx = divmod(t, 3)
        y = rows[None, :, None] + (ky - 1) + offsets[:, 2 * t]
        xx = cols[None, None, :] + (kx - 1) + offsets[:, 2 * t + 1]
        sample = _bilinear(flat, n, h, wd, y, xx)            # N, OH, OW, C
        out = out + torch.einsum("nhwc,fc->nfhw", sample, w[:, :, ky, kx])
    return out


def _upsample(x, size):
    fy, fx = size[0] // x.shape[-2], size[1] // x.shape[-1]
    return x.repeat_interleave(fy, -2).repeat_interleave(fx, -1)


def _block(p, ops, arch, pre, x, stride, down, dcn):
    relu = F.relu
    if arch["block"] == "basic":
        out = relu(ops.bn(ops.conv(x, p[f"{pre}.conv1.weight"], None, stride,
                                   1), p, f"{pre}.bn1"))
        mid_stride = 1
    else:
        out = relu(ops.bn(ops.conv(x, p[f"{pre}.conv1.weight"]), p,
                          f"{pre}.bn1"))
        mid_stride = stride
    w2 = p[f"{pre}.conv2.weight"]
    if dcn:
        offsets = ops.conv(out, p[f"{pre}.conv2.offset_conv.weight"],
                           p[f"{pre}.conv2.offset_conv.bias"], mid_stride, 1)
        out = ops.deform(out, offsets, w2, mid_stride)
    else:
        out = ops.conv(out, w2, None, mid_stride, 1)
    out = ops.bn(out, p, f"{pre}.bn2")
    if arch["block"] == "bottleneck":
        out = ops.bn(ops.conv(relu(out), p[f"{pre}.conv3.weight"]), p,
                     f"{pre}.bn3")
    if down:
        x = ops.bn(ops.conv(x, p[f"{pre}.downsample.0.weight"], None, stride),
                   p, f"{pre}.downsample.1")
    return relu(out + x)


def _stage(p, ops, arch, s, x):
    for st, _, pre, _, _, stride, down in _blocks(arch):
        if st == s:
            x = _block(p, ops, arch, pre, x, stride, down,
                       arch["dcn"] and s > 0)
    return x


def _cbr(p, ops, name, x, pad):
    return F.relu(ops.bn(ops.conv(x, p[f"{name}.conv.weight"],
                                  p[f"{name}.conv.bias"], 1, pad),
                         p, f"{name}.bn"))


def _branch_logit(p, ops, name, x):
    h = F.relu(ops.bn(ops.conv(x, p[f"{name}.0.weight"],
                               p.get(f"{name}.0.bias"), 1, 1), p, f"{name}.1"))
    h = F.relu(ops.bn(ops.deconv(h, p[f"{name}.3.weight"],
                                 p[f"{name}.3.bias"]), p, f"{name}.4"))
    return ops.deconv(h, p[f"{name}.6.weight"], p[f"{name}.6.bias"])


def forward(p: dict, x: torch.Tensor, cfg: dict, ops: Ops,
            train: bool = False, prob_only: bool = False,
            remat: bool = False) -> torch.Tensor:
    """x: (N, 3, H, W) float32, the Caffe means already subtracted. Returns
    (N, 3, H, W) = (P, T, B̂) with ``train``, else (N, 2, H, W) = (P, T),
    or with ``prob_only`` (N, 1, H, W) = P. ``remat`` recomputes each
    backbone stage in the backward instead of keeping its activations."""
    arch = ARCHS[cfg["backbone"]]
    x = F.relu(ops.bn(ops.conv(x, p["backbone.conv1.weight"], None, 2, 3), p,
                      "backbone.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    feats = []
    for s in range(4):
        if remat:
            x = checkpoint(_stage, p, ops, arch, s, x, use_reentrant=False)
        else:
            x = _stage(p, ops, arch, s, x)
        feats.append(x)
    c2, c3, c4, c5 = feats
    body = "segmentation_body"
    p5 = _cbr(p, ops, f"{body}.reduce_conv_c5", c5, 0)
    p4 = _cbr(p, ops, f"{body}.smooth_p4", _upsample(p5, c4.shape[-2:])
              + _cbr(p, ops, f"{body}.reduce_conv_c4", c4, 0), 1)
    p3 = _cbr(p, ops, f"{body}.smooth_p3", _upsample(p4, c3.shape[-2:])
              + _cbr(p, ops, f"{body}.reduce_conv_c3", c3, 0), 1)
    p2 = _cbr(p, ops, f"{body}.smooth_p2", _upsample(p3, c2.shape[-2:])
              + _cbr(p, ops, f"{body}.reduce_conv_c2", c2, 0), 1)
    size = p2.shape[-2:]
    cat = torch.cat([p2, _upsample(p3, size), _upsample(p4, size),
                     _upsample(p5, size)], 1)
    y = F.relu(ops.bn(ops.conv(cat, p[f"{body}.conv.0.weight"],
                               p[f"{body}.conv.0.bias"], 1, 1), p,
                      f"{body}.conv.1"))
    prob = torch.sigmoid(_branch_logit(p, ops, "segmentation_head.binarize",
                                       y))
    if prob_only:
        return prob
    thresh = torch.sigmoid(_branch_logit(p, ops, "segmentation_head.thresh",
                                         y))
    if not train:
        return torch.cat([prob, thresh], 1)
    return torch.cat([prob, thresh,
                      torch.sigmoid(K_STEP * (prob - thresh))], 1)


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and back to float32; a float8 format or
    int8 at a per-tensor scale (its absolute maximum to the format's
    largest value; int8 symmetric, to ±127)."""
    if dtype.itemsize > 1:
        return t.to(dtype).float()
    if dtype == torch.int8:
        scale = t.abs().amax().clamp(min=1e-30) / 127.0
        return torch.round(t / scale).clamp(-127, 127) * scale
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).float() * scale


class RoundedOps(Ops):
    """Every conv, deconv and deformable conv computed in a lower
    precision: its input, kernel and output rounded to ``forward`` going
    forward, and their gradients to ``backward`` going back."""

    forward_dtype = backward_dtype = torch.float32

    def _r(self, t):
        return _Round.apply(t, self.forward_dtype, self.backward_dtype)

    def conv(self, x, w, b=None, stride=1, pad=0):
        y = self._r(super().conv(self._r(x), self._r(w), None, stride, pad))
        return y if b is None else y + b[:, None, None]

    def deconv(self, x, w, b):
        return self._r(super().deconv(self._r(x), self._r(w), None)) \
            + b[:, None, None]

    def deform(self, x, offsets, w, stride):
        return self._r(super().deform(self._r(x), offsets, self._r(w),
                                      stride))


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, forward_dtype, backward_dtype):
        ctx.backward_dtype = backward_dtype
        return _round(t, forward_dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.backward_dtype), None, None


class Fp8Ops(RoundedOps):
    """The control, the precision step below the configuration's
    bfloat16: float8, e4m3 going forward and e5m2 going back (the usual
    float8 training recipe)."""

    forward_dtype = torch.float8_e4m3fn
    backward_dtype = torch.float8_e5m2


class Int8Ops(RoundedOps):
    """The control of a training cell, the precision step below the
    configuration's bfloat16: every conv's input, kernel, output and their
    gradients in int8 at per-tensor scales, as a training step built on
    the port's int8 convolution would compute."""

    forward_dtype = backward_dtype = torch.int8


class Bf16Ops(RoundedOps):
    """bfloat16 both ways: the configuration's own precision, a witness
    of what its rounding alone does to the numbers compared."""

    forward_dtype = backward_dtype = torch.bfloat16
