"""Int8 convolution for the quantized inference forward.

Every int8 convolution of the forward is one custom op,
``dbtext::int8_conv`` (``int8_conv``): on CUDA tensors a kernel written by
hand for Hopper (``csrc/int8_conv.cu``), an implicit-GEMM int8 x int8 ->
int32 convolution on the tensor cores (``wgmma``) that gathers its input
straight from the NHWC map and applies P1's epilogue to the accumulators
in registers. It takes the place of the XLA convolution and fused
epilogue of the JAX int8 forward (``models/quant_infer.py:238-243``),
whose hand-written TPU form is the probe's ``_epi_kernel``
(``benchmarks/int8_conv_probe.py:103-122``). On CPU tensors it runs its
plain version, ``int8_conv_plain``: ``int8_conv2d`` (im2col over NHWC int8
and ``torch._int_mm`` into int32, as exact as ``conv_general_dilated(...,
preferred_element_type=int32)``) followed by ``int8_epilogue_plain``.

P1 ``int8_epilogue`` stays as its own kernel and op
(``csrc/int8_epilogue.cu``, ``dbtext::int8_epilogue``): the TPU kernel's
one-to-one counterpart over an int32 map, and the yardstick the
convolution is timed against. The forward no longer calls it.

Around them, in plain PyTorch: per-tensor activation quantization
(``quantize_per_tensor``, ``dynamic_scale``).

On a CUDA tensor each op launches its kernel, counts the launch in
``LAUNCHES`` and raises if the kernel does not build or launch or does not
take the shape; on a CPU tensor it runs the plain version. Both give the
same bits: exact integer sums, f32 product then f32 add, the reciprocal of
the output scale multiplied, round half to even, clip to +-127.
"""

import ctypes
import os
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ._native import CSRC, build_library, check_launch, on_cuda, stream_of

# every launch counts in its kernel's name and in the count of its form
LAUNCHES = {"int8_conv": 0, "int8_conv_int8": 0, "int8_conv_f32": 0,
            "int8_epilogue": 0, "int8_epilogue_int8": 0,
            "int8_epilogue_f32": 0}

_LIBS: dict = {}
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _count(kernel: str, int8_form: bool) -> None:
    LAUNCHES[kernel] += 1
    LAUNCHES[f"{kernel}_int8" if int8_form else f"{kernel}_f32"] += 1


def load_library(name: str = "int8_epilogue") -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (first call only) and bind its entry:
    ``int8_epilogue`` (P1) or ``int8_conv``."""
    with _LIB_LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(build_library(os.path.join(CSRC, name + ".cu"),
                                            "lib" + name, "cuda"))
            p, i = ctypes.c_void_p, ctypes.c_int
            entry = getattr(lib, name)
            entry.argtypes = ([p] * 5 + [ctypes.c_longlong, i, i, p]
                              if name == "int8_epilogue"
                              else [p] * 6 + [i] * 12 + [p])
            entry.restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]


def _requantize(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """clip(round(x * inv), -127, 127) as int8; round half to even."""
    return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)


def quantize_per_tensor(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 of ``x`` at scale ``sx`` (a 0-d f32
    tensor): round(x * (1 / sx)) clipped to +-127."""
    return _requantize(x, torch.reciprocal(sx))


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """max(amax|x|, 1e-6) / 127 as a 0-d f32 tensor on ``x``'s device: no
    host synchronisation. The division is a true division by a device
    tensor (PyTorch divides a CUDA tensor by a Python number through its
    reciprocal)."""
    amax = torch.clamp_min(x.abs().amax().float(), 1e-6)
    return torch.div(amax, torch.full((), 127.0, device=x.device))


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def pad_cols(w_cols: np.ndarray) -> np.ndarray | None:
    """An int8 kernel's (Cout, K) column matrix zero-padded to multiples of
    8 in both dimensions, as the card's int8 GEMM takes them; None when it
    already is."""
    n, k = w_cols.shape
    if (n, k) == (_up8(n), _up8(k)):
        return None
    out = np.zeros((_up8(n), _up8(k)), np.int8)
    out[:n, :k] = w_cols
    return out


def im2col(q: torch.Tensor, k: int, stride: int, pad: int,
           width: int | None = None) -> torch.Tensor:
    """The (N*Ho*Wo, width) int8 column matrix of NHWC ``q``, zero padded by
    ``pad``: row p holds output pixel p's k*k taps in (kh, kw, cin) order,
    then zero columns up to ``width`` (default k*k*Cin). Two ``unfold``
    views and one copy."""
    if pad:
        q = F.pad(q, (0, 0, pad, pad, pad, pad))
    n, cin = q.shape[0], q.shape[3]
    win = q.unfold(1, k, stride).unfold(2, k, stride)  # N,Ho,Wo,C,kh,kw
    ho, wo = win.shape[1], win.shape[2]
    taps = win.permute(0, 1, 2, 4, 5, 3)
    kk = k * k * cin
    if width is None or width == kk:
        return taps.reshape(n * ho * wo, kk)
    cols = q.new_zeros((n * ho * wo, width))
    cols[:, :kk].view(n, ho, wo, k, k, cin).copy_(taps)
    return cols


def int8_conv2d(q: torch.Tensor, w_cols: torch.Tensor, k: int, stride: int,
                pad: int) -> torch.Tensor:
    """int8 x int8 -> int32 convolution of NHWC ``q`` (N, H, W, Cin) with
    ``w_cols`` (Cout, K), the kernel in (kh, kw, cin) order, zero padded by
    ``pad`` on every side. K is k*k*Cin, or more where ``pad_cols`` padded
    it: the columns get as many zero columns. Returns int32 (N, Ho, Wo,
    Cout): ``im2col`` then ``torch._int_mm``."""
    n, h, w, _ = q.shape
    cols = im2col(q, k, stride, pad, w_cols.shape[1])
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    m = cols.shape[0]
    # torch._int_mm on CUDA takes more than 16 rows; is_cuda first, so that
    # a CPU export puts no guard on a symbolic batch
    if cols.is_cuda and m <= 16:
        cols = torch.cat([cols, cols.new_zeros((17 - m, cols.shape[1]))])
    acc = torch._int_mm(cols, w_cols.t())[:m]
    return acc.view(n, ho, wo, w_cols.shape[0])


def int8_epilogue_plain(acc: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, relu: bool,
                        out_scale: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Plain version of P1: relu?(acc * scale + bias) in f32, or with
    ``out_scale`` that requantized to int8 at it."""
    y = acc.float() * scale + bias
    if relu:
        y = torch.relu(y)
    if out_scale is None:
        return y
    return _requantize(y, torch.reciprocal(out_scale))


def _check(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
           ) -> None:
    if acc.dim() != 2 or acc.dtype != torch.int32:
        raise TypeError(f"acc must be int32 (M, C), got {acc.dtype} "
                        f"{tuple(acc.shape)}")
    c = acc.shape[1]
    if c % 4:
        raise ValueError(f"the channel count {c} is not a multiple of 4")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise TypeError(f"{name} must be f32 ({c},), got {t.dtype} "
                            f"{tuple(t.shape)}")
    if not (acc.is_contiguous() and scale.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("int8_epilogue takes contiguous tensors")


@torch.library.custom_op("dbtext::int8_epilogue", mutates_args=())
def _epilogue_op(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 relu: bool, out_scale: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The CPU implementation: the plain version."""
    _check(acc, scale, bias)
    return int8_epilogue_plain(acc, scale, bias, relu, out_scale)


@_epilogue_op.register_kernel("cuda")
def _epilogue_cuda(acc, scale, bias, relu, out_scale):
    """The CUDA implementation: P1's kernel, or a raise."""
    _check(acc, scale, bias)
    # the dispatcher chose CUDA: on_cuda raises if the inputs mix devices
    on_cuda(acc, scale, bias, *([] if out_scale is None else [out_scale]))
    if any(t.data_ptr() % 16 for t in (acc, scale, bias)):
        raise ValueError("int8_epilogue takes 16-byte aligned tensors")
    m, c = acc.shape
    inv = None
    if out_scale is not None:
        inv = torch.reciprocal(out_scale.reshape(()).float())
    out = torch.empty((m, c), dtype=torch.int8 if inv is not None
                      else torch.float32, device=acc.device)
    err = load_library().int8_epilogue(
        acc.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if inv is None else inv.data_ptr(), out.data_ptr(), m, c,
        int(relu), stream_of(acc))
    check_launch(err, "int8_epilogue")
    if m:
        _count("int8_epilogue", inv is not None)
    return out


@_epilogue_op.register_fake
def _epilogue_fake(acc, scale, bias, relu, out_scale):
    return acc.new_empty(acc.shape, dtype=torch.int8 if out_scale is not None
                         else torch.float32)


def int8_epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  relu: bool, out_scale: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """P1 over int32 (M, C) accumulators, per channel ``scale`` and
    ``bias`` (C,) f32: the f32 ``relu?(acc * scale + bias)``, or, with
    ``out_scale`` (a 0-d f32 tensor), that requantized to int8 at it.
    Dispatches to the custom op ``dbtext::int8_epilogue``: its kernel on
    CUDA tensors, its plain version on CPU ones."""
    return torch.ops.dbtext.int8_epilogue(acc, scale, bias, relu, out_scale)


# ------------------------------------------------- the int8 convolution ---

def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _out_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def int8_conv_plain(q: torch.Tensor, w_cols: torch.Tensor, k: int,
                    stride: int, pad: int, scale: torch.Tensor,
                    bias: torch.Tensor, relu: bool,
                    out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``int8_conv``: ``int8_conv2d`` then
    ``int8_epilogue_plain``."""
    acc = int8_conv2d(q.contiguous(), w_cols, k, stride, pad)
    rows = w_cols.shape[0]
    return int8_epilogue_plain(acc.view(-1, rows), scale, bias, relu,
                               out_scale).view(acc.shape)


def _check_conv(q, w_cols, k, stride, pad, scale, bias, out_scale) -> None:
    if q.dim() != 4 or q.dtype != torch.int8:
        raise TypeError(f"q must be int8 NHWC, got {q.dtype} "
                        f"{tuple(q.shape)}")
    if w_cols.dim() != 2 or w_cols.dtype != torch.int8:
        raise TypeError(f"w_cols must be int8 (Cout, K), got "
                        f"{w_cols.dtype} {tuple(w_cols.shape)}")
    if k < 1 or stride < 1 or pad < 0:
        raise ValueError(f"k {k}, stride {stride}, pad {pad}")
    _, h, w, cin = q.shape
    if _out_size(h, k, stride, pad) < 1 or _out_size(w, k, stride, pad) < 1:
        raise ValueError(f"a {k}x{k} window at pad {pad} does not fit a "
                         f"{h}x{w} input")
    if w_cols.shape[1] < k * k * cin:
        raise ValueError(f"w_cols has {w_cols.shape[1]} columns, fewer than "
                         f"k*k*Cin = {k * k * cin}")
    rows = w_cols.shape[0]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (rows,):
            raise TypeError(f"{name} must be f32 ({rows},), got {t.dtype} "
                            f"{tuple(t.shape)}")
    if out_scale is not None and (out_scale.dtype != torch.float32
                                  or out_scale.numel() != 1):
        raise TypeError("out_scale must be one f32 value")


def _padded_input(q: torch.Tensor, cs: int) -> tuple[torch.Tensor, int]:
    """``q`` as the kernel reads it, and its pixel stride in bytes: the
    tensor itself where its pixels lie a multiple of 16 bytes apart, at
    least ``cs`` bytes each, in NHWC order and 16-byte aligned (the full
    widths, and a channel slice of an earlier ``int8_conv``'s output whose
    rows ``pad_cols`` padded to a multiple of 16); else a copy with the
    channels zero-padded to ``cs``."""
    n, h, w, cin = q.shape
    ld = q.stride(2)
    if (q.stride(3) == 1 and ld % 16 == 0 and ld >= cs
            and q.stride(1) == w * ld and q.stride(0) == h * w * ld
            and q.data_ptr() % 16 == 0
            and (q.storage_offset() + n * h * w * ld
                 <= q.untyped_storage().nbytes())):
        return q, ld
    out = q.new_zeros((n, h, w, cs))
    out[..., :cin] = q
    return out, cs


def _tap_weights(w_cols: torch.Tensor, k: int, cin: int, cs: int
                 ) -> torch.Tensor:
    """(Cout, k*k*cs) int8: each tap's ``cin`` weights zero-padded to
    ``cs``, the layout the kernel reads in 16-byte chunks."""
    rows = w_cols.shape[0]
    if (w_cols.shape[1] == k * k * cs and w_cols.is_contiguous()
            and w_cols.data_ptr() % 16 == 0):
        return w_cols
    out = w_cols.new_zeros((rows, k * k, cs))
    out[..., :cin] = w_cols[:, :k * k * cin].reshape(rows, k * k, cin)
    return out.view(rows, k * k * cs)


@torch.library.custom_op("dbtext::int8_conv", mutates_args=())
def _conv_op(q: torch.Tensor, w_cols: torch.Tensor, k: int, stride: int,
             pad: int, scale: torch.Tensor, bias: torch.Tensor, relu: bool,
             out_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The CPU implementation: the plain version."""
    _check_conv(q, w_cols, k, stride, pad, scale, bias, out_scale)
    return int8_conv_plain(q, w_cols, k, stride, pad, scale, bias, relu,
                           out_scale)


@_conv_op.register_kernel("cuda")
def _conv_cuda(q, w_cols, k, stride, pad, scale, bias, relu, out_scale):
    """The CUDA implementation: the kernel, or a raise."""
    _check_conv(q, w_cols, k, stride, pad, scale, bias, out_scale)
    on_cuda(q, w_cols, scale, bias,
            *([] if out_scale is None else [out_scale]))
    rows = w_cols.shape[0]
    if rows % 8:
        raise ValueError(f"the output channel count {rows} is not a "
                         f"multiple of 8 (ops.int8.pad_cols pads it)")
    if not (scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("int8_conv takes contiguous scales and biases")
    n, h, w, cin = q.shape
    cs = _up16(cin)
    qk, ldq = _padded_input(q, cs)
    wk = _tap_weights(w_cols, k, cin, cs)
    ho, wo = _out_size(h, k, stride, pad), _out_size(w, k, stride, pad)
    osc = None if out_scale is None else out_scale.reshape(())
    out = torch.empty((n, ho, wo, rows), device=q.device,
                      dtype=torch.float32 if osc is None else torch.int8)
    err = load_library("int8_conv").int8_conv(
        qk.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if osc is None else osc.data_ptr(), out.data_ptr(), n, h, w,
        ldq, cs // 16, k, stride, pad, ho, wo, rows, int(relu),
        stream_of(q))
    check_launch(err, "int8_conv")
    if out.numel():
        _count("int8_conv", osc is not None)
    return out


@_conv_op.register_fake
def _conv_fake(q, w_cols, k, stride, pad, scale, bias, relu, out_scale):
    n, h, w, _ = q.shape
    return q.new_empty(
        (n, _out_size(h, k, stride, pad), _out_size(w, k, stride, pad),
         w_cols.shape[0]),
        dtype=torch.float32 if out_scale is None else torch.int8)


def int8_conv(q: torch.Tensor, w_cols: torch.Tensor, k: int, stride: int,
              pad: int, scale: torch.Tensor, bias: torch.Tensor, relu: bool,
              out_scale: torch.Tensor | None = None) -> torch.Tensor:
    """int8 convolution of NHWC ``q`` (N, H, W, Cin) with ``w_cols`` (Cout,
    K), the kernel in (kh, kw, cin) order (K = k*k*Cin, or more where
    ``pad_cols`` padded it), zero padded by ``pad``, at ``stride``, then
    P1's epilogue with per-channel ``scale`` and ``bias`` (Cout,) f32: the
    f32 ``relu?(acc * scale + bias)`` (N, Ho, Wo, Cout), or, with
    ``out_scale`` (one f32 value), that requantized to int8 at it.
    Dispatches to the custom op ``dbtext::int8_conv``: its kernel on CUDA
    tensors, its plain version on CPU ones."""
    return torch.ops.dbtext.int8_conv(q, w_cols, k, stride, pad, scale,
                                      bias, relu, out_scale)
