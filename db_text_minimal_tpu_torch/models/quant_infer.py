"""BN-folded and int8 inference forward for the flagship detector.

Counterpart of ``db_text_minimal_tpu/models/quant_infer.py``: BatchNorm
folded into every conv and deconv offline; with ``min_out_channels=128``
the wide convs (Cout >= 128, Cin >= 64: layers 2-4, the FPN output conv
and, unless skipped, the fused head's conv1) are int8 with symmetric
per-output-channel weights and symmetric per-tensor activations, at static
calibrated scales (``calibrate_activation_scales``) or dynamic abs-max ones.
The other convs and the deconvs run in the compute dtype: bf16 on the card,
f32 on the CPU, as the JAX package's ``_compute_dtype`` chooses.

An int8 conv is one call of ``ops.int8.int8_conv``, the custom op
``dbtext::int8_conv``: on the card a tensor-core implicit-GEMM kernel with
P1's epilogue in its register tail, on the CPU im2col and
``torch._int_mm`` into int32 then P1's plain version (K and N zero-padded
to multiples of 8 where a pruned width leaves them otherwise). It gives
the f32 ``relu?(acc * sx*eff + bias)`` the JAX forward computes at
``quant_infer.py:238-243``, or, where an int8 conv feeds the next int8
conv directly after relu and that conv has a static scale (conv1 -> conv2
of each block in layers 2-4, the FPN output conv -> the head's conv1),
the next conv's int8 input at once. Both forms give the bits of the
unfused chain; ``fuse=False`` runs the unfused one.

Activations are NHWC tensors as in the JAX package; the float convs see
them as channels-last NCHW views. The folded tree mirrors the JAX tree
(``{"params": {"backbone": {"conv1": ..., "layer2_0": {...}}, ...}}``)
with torch leaves: float conv kernels OIHW, int8 conv kernels OHWI (the
column order of the im2col), deconv kernels in ``ConvTranspose2d``'s
(in, out, kh, kw), ``bias`` and ``eff_scale`` f32 (C,), ``act_scale`` a 0-d
f32 tensor. ``weights.quant_vars_from_jax`` carries the JAX package's tree
into it.

Two weight-exact rewrites, off by default as in the JAX package, chosen in
``prepare_quant_params`` and recognised by the forward from the kernels'
shapes:

- ``stem_s2d``: the 7x7/s2 stem, pad 3, over (N, H, W, 3) becomes a 4x4/s1
  conv, pad ((2, 1), (2, 1)), over the 2x2 space-to-depth input (N, H/2,
  W/2, 12), channels in (dy, dx, c) order. Its kernel is OIHW (64, 12, 4,
  4) (OHWI (64, 4, 4, 12) when int8): the 7x7 kernel padded to 8x8 with a
  leading zero row and column, each 2x2 block folded into the channels
  (``_s2d_stem_kernel``). Every tap is the original's.
- ``deconv_d2s``: each of the head's 2x2/s2 transposed convs, which writes
  ``y[2i+dy, 2j+dx, o] = sum_c x[i, j, c] * W[c, o, dy, dx]`` for
  ``ConvTranspose2d``'s (in, out, 2, 2) kernel W, becomes a 1x1 OIHW kernel
  (4*cout, cin, 1, 1), channels in (dy, dx, o) order, with no spatial flip
  (``_d2s_deconv_kernel``; the JAX kernel flips because
  ``lax.conv_transpose`` applies it flipped): one product per pixel, then
  ``_depth_to_space``. The bias stays (cout,).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.int8 import (dynamic_scale, int8_conv, pad_cols,
                        quantize_per_tensor)
from .layers import (max_pool_3x3_s2, resize_bilinear_align_corners,
                     resize_nearest)

DEFAULT_SKIP = ("segmentation_head",)

_BN = ("weight", "bias", "running_mean", "running_var")


def _compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU (where bf16 is slow emulation)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


# ---------------------------------------------------------------------------
# Offline preparation: BN folding + selective int8 quantization
# ---------------------------------------------------------------------------

def _fold(weight: np.ndarray, bias=None, bn: dict | None = None,
          out_axis: int = 0, eps: float = 1e-5) -> dict:
    """Fold BatchNorm into a conv (OIHW, ``out_axis=0``) or a transposed
    conv ((in, out, kh, kw), ``out_axis=1``) -> {kernel, bias} f32, in the
    JAX package's numpy op order, so that every folded value is the same
    f32."""
    k = np.asarray(weight, np.float32)
    b = np.asarray(np.zeros(k.shape[out_axis]) if bias is None else bias,
                   np.float32)
    if bn is not None:
        inv = np.float32(1.0) / np.sqrt(
            np.asarray(bn["running_var"], np.float32) + eps)
        g = np.asarray(bn["weight"], np.float32) * inv
        shape = [1] * k.ndim
        shape[out_axis] = -1
        k = k * g.reshape(shape)
        b = (b - np.asarray(bn["running_mean"], np.float32)) * g \
            + np.asarray(bn["bias"], np.float32)
    return {"kernel": k, "bias": b}


def _quantize(node: dict) -> dict:
    """Per-output-channel symmetric int8 of a folded OIHW conv; the int8
    kernel is stored OHWI. Where Cout or k*k*Cin is not a multiple of 8 (a
    pruned width), ``w_cols`` holds the column matrix zero-padded to
    multiples of 8 (``ops.int8.pad_cols``) and ``eff_scale`` and ``bias``
    are zero-padded to its rows."""
    k = node["kernel"]
    amax = np.abs(k).max(axis=(1, 2, 3), keepdims=True)
    scale = np.maximum(amax / 127.0, 1e-12)
    q = np.ascontiguousarray(np.clip(np.round(k / scale), -127,
                                     127).astype(np.int8).transpose(0, 2, 3, 1))
    out = {"kernel": q, "eff_scale": scale.reshape(-1).astype(np.float32),
           "bias": node["bias"]}
    w_cols = pad_cols(q.reshape(q.shape[0], -1))
    if w_cols is not None:
        out["w_cols"] = w_cols
        for key in ("eff_scale", "bias"):
            out[key] = np.pad(out[key], (0, w_cols.shape[0] - q.shape[0]))
    return out


def _s2d_stem_kernel(k7: np.ndarray) -> np.ndarray:
    """The stem's OIHW (cout, cin, 7, 7) kernel -> the weight-exact OIHW
    (cout, 4*cin, 4, 4) kernel of a stride-1 conv, pad ((2, 1), (2, 1)),
    over ``_space_to_depth`` of the input: padded to 8x8 with a leading
    zero row and column (tap offset -4), then each 2x2 block (dy, dx) of
    the taps folded into the input channels in (dy, dx, c) order."""
    cout, cin, kh, kw = k7.shape
    k8 = np.zeros((cout, cin, kh + 1, kw + 1), k7.dtype)
    k8[:, :, 1:, 1:] = k7
    k4 = k8.reshape(cout, cin, (kh + 1) // 2, 2, (kw + 1) // 2, 2)
    return np.ascontiguousarray(k4.transpose(0, 3, 5, 1, 2, 4)).reshape(
        cout, 4 * cin, (kh + 1) // 2, (kw + 1) // 2)


def _d2s_deconv_kernel(k: np.ndarray) -> np.ndarray:
    """A 2x2/s2 transposed conv's (cin, cout, 2, 2) kernel -> the
    weight-exact 1x1 OIHW kernel (4*cout, cin, 1, 1) of a 1x1 conv followed
    by ``_depth_to_space``: ``ConvTranspose2d`` at stride 2, kernel 2, pad 0
    writes ``y[2i+dy, 2j+dx, o] = sum_c x[i, j, c] * k[c, o, dy, dx]``, so
    output channel (dy, dx, o) takes k[:, o, dy, dx], unflipped."""
    cin, cout, kh, kw = k.shape
    assert (kh, kw) == (2, 2), k.shape
    return np.ascontiguousarray(k.transpose(2, 3, 1, 0)).reshape(
        4 * cout, cin, 1, 1)


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC (N, H, W, C) -> (N, H/2, W/2, 4C), channel order (dy, dx, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def _depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """NHWC (N, H, W, 4C), channel order (dy, dx, c) -> (N, 2H, 2W, C): the
    inverse of ``_space_to_depth``."""
    n, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(n, h, w, 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, c)


def tree_to(tree, device) -> dict:
    """The folded tree with numpy or torch leaves as torch tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def prepare_quant_params(state_dict: dict, skip: tuple = DEFAULT_SKIP,
                         min_out_channels: int = 128,
                         min_in_channels: int = 64,
                         stem_s2d: bool = False,
                         deconv_d2s: bool = False) -> dict:
    """A ``DBTextModel`` state_dict in the ``FusedDBHead`` layout
    (``head.fuse_variables`` first) -> the folded, selectively quantized
    tree for ``quant_dbnet_forward``, on the CPU (``tree_to`` moves it).

    Subtrees whose path names an entry of ``skip`` stay float (default: the
    segmentation head). ``min_out_channels=10**9`` gives the BN-folded
    float forward. ``stem_s2d`` rewrites the folded stem into its
    space-to-depth form (``_s2d_stem_kernel``; Cout 64 and Cin 12, so it
    stays float unless ``min_out_channels`` and ``min_in_channels`` are
    lowered), ``deconv_d2s`` the head's
    folded transposed convs into 1x1 conv + depth-to-space
    (``_d2s_deconv_kernel``), both before quantization, as the JAX
    package does."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}

    def bn(prefix):
        return {k: sd[f"{prefix}.{k}"] for k in _BN}

    def conv(prefix, bn_prefix=None):
        return _fold(sd[f"{prefix}.weight"], sd.get(f"{prefix}.bias"),
                     bn(bn_prefix) if bn_prefix else None)

    def maybe_quant(node, path):
        k = node["kernel"]
        if (any(name in path for name in skip) or k.ndim != 4
                or k.shape[0] < min_out_channels
                or k.shape[1] < min_in_channels):
            return node
        return _quantize(node)

    out: dict = {"backbone": {}, "segmentation_body": {},
                 "segmentation_head": {}}
    ob = out["backbone"]
    stem = conv("backbone.conv1", "backbone.bn1")
    if stem_s2d:
        stem["kernel"] = _s2d_stem_kernel(stem["kernel"])
    ob["conv1"] = maybe_quant(stem, ("backbone", "conv1"))
    for stage in range(1, 5):
        for block in range(2):
            name = f"layer{stage}_{block}"
            pre = f"backbone.layer{stage}.{block}"
            path = ("backbone", name)
            node = {"conv1": maybe_quant(conv(f"{pre}.conv1", f"{pre}.bn1"),
                                         path),
                    "conv2": maybe_quant(conv(f"{pre}.conv2", f"{pre}.bn2"),
                                         path)}
            if f"{pre}.downsample.0.weight" in sd:
                node["downsample_conv"] = maybe_quant(
                    conv(f"{pre}.downsample.0", f"{pre}.downsample.1"), path)
            ob[name] = node
    onk = out["segmentation_body"]
    for name in ("reduce_conv_c5", "reduce_conv_c4", "reduce_conv_c3",
                 "reduce_conv_c2", "smooth_p4", "smooth_p3", "smooth_p2"):
        pre = f"segmentation_body.{name}"
        onk[name] = maybe_quant(conv(f"{pre}.conv", f"{pre}.bn"),
                                ("segmentation_body", name))
    onk["conv"] = maybe_quant(conv("segmentation_body.conv.0",
                                   "segmentation_body.conv.1"),
                              ("segmentation_body", "conv"))
    assert "segmentation_head.binarize_deconv1.weight" in sd, \
        "the folded forward expects the FusedDBHead layout (fuse_variables)"
    oh = out["segmentation_head"]
    oh["conv1"] = maybe_quant(conv("segmentation_head.conv1",
                                   "segmentation_head.bn1"),
                              ("segmentation_head", "conv1"))
    for branch in ("binarize", "thresh"):
        pre = f"segmentation_head.{branch}"
        d1 = _fold(sd[f"{pre}_deconv1.weight"], sd[f"{pre}_deconv1.bias"],
                   bn(f"{pre}_bn2"), out_axis=1)
        d2 = _fold(sd[f"{pre}_deconv2.weight"], sd[f"{pre}_deconv2.bias"],
                   out_axis=1)
        if deconv_d2s:
            d1["kernel"] = _d2s_deconv_kernel(d1["kernel"])
            d2["kernel"] = _d2s_deconv_kernel(d2["kernel"])
        oh[f"{branch}_deconv1"] = d1
        oh[f"{branch}_deconv2"] = d2
    return tree_to({"params": out}, "cpu")


# ---------------------------------------------------------------------------
# Folded forward
# ---------------------------------------------------------------------------

@dataclass
class _Run:
    """What one forward's convs share: the float convs' dtype, whether P1
    may write the next conv's int8 input, and the optional records (each
    int8 conv's input abs-max for calibration; its int8 input)."""
    ct: torch.dtype
    fuse: bool
    maxes: list | None = None
    int8_inputs: list | None = None


def _is_int8(node: dict) -> bool:
    return node["kernel"].dtype == torch.int8


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _ksize(kernel: torch.Tensor) -> int:
    """A folded conv kernel's spatial size: OHWI when int8, else OIHW."""
    return kernel.shape[1] if kernel.dtype == torch.int8 else kernel.shape[2]


def _fconv(x, node, run: _Run, stride=1, pad=1, relu=False,
           out_scale=None):
    """Folded conv of NHWC ``x``. int8 (static ``act_scale`` if calibrated,
    dynamic abs-max otherwise) through ``int8_conv``, which returns f32, or
    int8 at ``out_scale``; an int8 ``x`` is such an output, already
    quantized at this conv's ``act_scale``. Float convs run in ``run.ct``,
    then bias (and relu) in f32. ``pad`` is a symmetric int or an explicit
    ((top, bottom), (left, right)), which zero-pads the input (the int8
    input after quantization: int8 zero is exact) for a conv at pad 0."""
    kernel = node["kernel"]
    widths = None
    if not isinstance(pad, int):
        (top, bottom), (left, right) = pad
        widths, pad = (0, 0, left, right, top, bottom), 0
    if kernel.dtype == torch.int8:
        if x.dtype == torch.int8:
            q, sx = x, node["act_scale"]
        else:
            if run.maxes is not None:
                run.maxes.append(x.abs().amax())
            sx = (node["act_scale"] if "act_scale" in node
                  else dynamic_scale(x))
            q = quantize_per_tensor(x, sx)
        if run.int8_inputs is not None:
            run.int8_inputs.append(q)
        if widths is not None:
            q = F.pad(q, widths)
        cout = kernel.shape[0]
        w_cols = node.get("w_cols")
        if w_cols is None:
            w_cols = kernel.reshape(cout, -1)
        y = int8_conv(q, w_cols, kernel.shape[1], stride, pad,
                      sx * node["eff_scale"], node["bias"], relu, out_scale)
        # the padded rows' outputs are zero: drop them
        return y if w_cols.shape[0] == cout else y[..., :cout]
    if widths is not None:
        x = F.pad(x, widths)
    y = F.conv2d(_nchw(x).to(run.ct), kernel.to(run.ct), stride=stride,
                 padding=pad)
    y = _nhwc(y).float() + node["bias"]
    return torch.relu(y) if relu else y


def _fdeconv(x, node, run: _Run, relu=False):
    """Folded 2x2/s2 transposed conv in ``run.ct``; a 1x1 kernel (4*cout,
    cin, 1, 1) selects its ``deconv_d2s`` form, one product per pixel into
    (dy, dx, o) channels, then ``_depth_to_space``. Bias and relu in
    f32."""
    kernel = node["kernel"]
    if kernel.shape[-1] == 1:
        w = kernel.to(run.ct).reshape(kernel.shape[0], -1)
        y = _depth_to_space(torch.matmul(x.to(run.ct), w.t()))
    else:
        y = _nhwc(F.conv_transpose2d(_nchw(x).to(run.ct),
                                     kernel.to(run.ct), stride=2))
    y = y.float() + node["bias"]
    return torch.relu(y) if relu else y


def _feeds(run: _Run, node: dict, nxt: dict):
    """The next conv's static scale when P1 may write its int8 input."""
    if (run.fuse and _is_int8(node) and _is_int8(nxt)
            and "act_scale" in nxt):
        return nxt["act_scale"]
    return None


def _basic_block(x, p, stride, run: _Run):
    out = _fconv(x, p["conv1"], run, stride=stride, relu=True,
                 out_scale=_feeds(run, p["conv1"], p["conv2"]))
    out = _fconv(out, p["conv2"], run)
    if "downsample_conv" in p:
        x = _fconv(x, p["downsample_conv"], run, stride=stride, pad=0)
    return torch.relu(out + x)


def _up(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return _nhwc(resize_nearest(_nchw(x), like.shape[1:3]))


def quant_dbnet_forward(qvars: dict, x: torch.Tensor, prob_only: bool = False,
                        compute_dtype: torch.dtype | None = None,
                        fuse: bool = True, maxes: list | None = None,
                        int8_inputs: list | None = None) -> torch.Tensor:
    """Eval-mode forward: (N, H, W, 3) f32 on the tree's device -> (N, H,
    W, 2) maps in [0, 1], or with ``prob_only`` (N, H, W, 1), the prob map
    alone (the thresh branch is skipped). ``compute_dtype`` is the float
    convs' dtype (default bf16 on the card, f32 on the CPU). ``maxes``
    collects each int8 conv's input abs-max (calibration, which runs
    unfused); ``int8_inputs`` each int8 conv's int8 input."""
    p = qvars["params"]
    bp = p["backbone"]
    run = _Run(compute_dtype or _compute_dtype(x.device),
               fuse and maxes is None, maxes, int8_inputs)

    stem = bp["conv1"]
    if _ksize(stem["kernel"]) == 4:   # the space-to-depth stem (stem_s2d)
        h = _fconv(_space_to_depth(x), stem, run, stride=1,
                   pad=((2, 1), (2, 1)), relu=True)
    else:
        h = _fconv(x, stem, run, stride=2, pad=3, relu=True)
    h = _nhwc(max_pool_3x3_s2(_nchw(h)))
    feats = []
    for stage in range(1, 5):
        stride = 1 if stage == 1 else 2
        for block in range(2):
            h = _basic_block(h, bp[f"layer{stage}_{block}"],
                             stride if block == 0 else 1, run)
        feats.append(h)
    c2, c3, c4, c5 = feats

    np_ = p["segmentation_body"]
    p5 = _fconv(c5, np_["reduce_conv_c5"], run, pad=0, relu=True)
    p4 = _fconv(_up(p5, c4) + _fconv(c4, np_["reduce_conv_c4"], run, pad=0,
                                     relu=True),
                np_["smooth_p4"], run, relu=True)
    p3 = _fconv(_up(p4, c3) + _fconv(c3, np_["reduce_conv_c3"], run, pad=0,
                                     relu=True),
                np_["smooth_p3"], run, relu=True)
    p2 = _fconv(_up(p3, c2) + _fconv(c2, np_["reduce_conv_c2"], run, pad=0,
                                     relu=True),
                np_["smooth_p2"], run, relu=True)
    body = torch.cat([p2, _up(p3, p2), _up(p4, p2), _up(p5, p2)], dim=-1)
    hp = p["segmentation_head"]
    body = _fconv(body, np_["conv"], run, relu=True,
                  out_scale=_feeds(run, np_["conv"], hp["conv1"]))

    h1 = _fconv(body, hp["conv1"], run, relu=True)
    half = h1.shape[-1] // 2

    def tail(z, branch):
        z = _fdeconv(z, hp[f"{branch}_deconv1"], run, relu=True)
        z = _fdeconv(z, hp[f"{branch}_deconv2"], run)
        return torch.sigmoid(z)

    y = tail(h1[..., :half], "binarize")
    if not prob_only:
        y = torch.cat([y, tail(h1[..., half:], "thresh")], dim=-1)
    return _nhwc(resize_bilinear_align_corners(_nchw(y), x.shape[1:3]))


# ---------------------------------------------------------------------------
# Static activation-scale calibration
# ---------------------------------------------------------------------------

def _forward_conv_order(p: dict) -> list:
    """The int8-conv nodes in the order ``quant_dbnet_forward`` runs
    them."""
    order = []
    bp = p["backbone"]
    order.append(bp["conv1"])
    for stage in range(1, 5):
        for block in range(2):
            blk = bp[f"layer{stage}_{block}"]
            order.append(blk["conv1"])
            order.append(blk["conv2"])
            if "downsample_conv" in blk:
                order.append(blk["downsample_conv"])
    np_ = p["segmentation_body"]
    order += [np_["reduce_conv_c5"], np_["reduce_conv_c4"],
              np_["smooth_p4"], np_["reduce_conv_c3"], np_["smooth_p3"],
              np_["reduce_conv_c2"], np_["smooth_p2"], np_["conv"]]
    order.append(p["segmentation_head"]["conv1"])
    return [n for n in order if _is_int8(n)]


def calibrate_activation_scales(qvars: dict, sample_batches,
                                compute_dtype: torch.dtype | None = None
                                ) -> dict:
    """Attach static per-conv activation scales to a quantized tree: run
    the dynamic forward over the calibration batches (NHWC f32, numpy or
    torch) recording each int8 conv's input abs-max, then set ``act_scale
    = max / 127`` (the maxima's f64 quotient rounded to f32, as the JAX
    package computes it) on every int8 conv in forward order."""
    ordered = _forward_conv_order(qvars["params"])
    device = qvars["params"]["backbone"]["conv1"]["bias"].device
    maxes = None
    for batch in sample_batches:
        record: list = []
        x = torch.as_tensor(batch, dtype=torch.float32).to(device)
        with torch.inference_mode():
            quant_dbnet_forward(qvars, x, compute_dtype=compute_dtype,
                                maxes=record)
        batch_maxes = (torch.stack(record).double().cpu().numpy()
                       if record else np.zeros(0))
        maxes = (batch_maxes if maxes is None
                 else np.maximum(maxes, batch_maxes))
    assert maxes is not None and len(ordered) == len(maxes), \
        (len(ordered), maxes)
    for node, scale in zip(ordered, np.maximum(maxes, 1e-6) / 127.0):
        node["act_scale"] = torch.tensor(np.float32(scale), device=device)
    return qvars
