"""Int8 convolution for the quantized inference forward.

P1 ``int8_epilogue``, the epilogue of an int8 convolution, is a kernel
written by hand in CUDA for Hopper (``csrc/int8_epilogue.cu``). It replaces
the TPU kernel ``_epi_kernel`` / ``epilogue`` of
``benchmarks/int8_conv_probe.py:103-122``, the hand-written form of the
dequantize -> bias -> relu -> requantize chain that the JAX int8 forward
leaves to XLA's fusion (``models/quant_infer.py:243``). PyTorch has no such
fusion, so every int8 convolution of the forward ends in P1.

Around it, in plain PyTorch: per-tensor activation quantization
(``quantize_per_tensor``, ``dynamic_scale``) and the convolution itself,
``int8_conv2d``: im2col over NHWC int8 and ``torch._int_mm`` into int32, as
exact as the JAX package's ``conv_general_dilated(...,
preferred_element_type=int32)``.

On a CUDA tensor ``int8_epilogue`` launches its kernel, counts the launch in
``LAUNCHES`` and raises if the kernel does not build or launch; on a CPU
tensor it runs the plain version beside it. Both give the same bits: f32
product then f32 add, the reciprocal of the output scale multiplied, round
half to even, clip to +-127.
"""

import ctypes
import os
import threading
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ._native import CSRC, build_library, check_launch, on_cuda, stream_of

# every launch counts in "int8_epilogue" and in the count of its form
LAUNCHES = {"int8_epilogue": 0, "int8_epilogue_int8": 0,
            "int8_epilogue_f32": 0}

_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_library() -> ctypes.CDLL:
    """Build ``csrc/int8_epilogue.cu`` (first call only) and bind it."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library(
                os.path.join(CSRC, "int8_epilogue.cu"), "libint8_epilogue",
                "cuda"))
            p = ctypes.c_void_p
            lib.int8_epilogue.argtypes = [p, p, p, p, p, ctypes.c_longlong,
                                          ctypes.c_int, ctypes.c_int, p]
            lib.int8_epilogue.restype = ctypes.c_int
            _LIB = lib
    return _LIB


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


def int8_conv2d(q: torch.Tensor, w_cols: torch.Tensor, k: int, stride: int,
                pad: int) -> torch.Tensor:
    """int8 x int8 -> int32 convolution of NHWC ``q`` (N, H, W, Cin) with
    ``w_cols`` (Cout, K), the kernel in (kh, kw, cin) order, zero padded by
    ``pad`` on every side. K is k*k*Cin, or more where ``pad_cols`` padded
    it: the columns get as many zero columns. Returns int32 (N, Ho, Wo,
    Cout). The column matrix is (N*Ho*Wo, K) int8, built by two ``unfold``
    views and one copy."""
    if pad:
        q = F.pad(q, (0, 0, pad, pad, pad, pad))
    n, cin = q.shape[0], q.shape[3]
    win = q.unfold(1, k, stride).unfold(2, k, stride)  # N,Ho,Wo,C,kh,kw
    ho, wo = win.shape[1], win.shape[2]
    taps = win.permute(0, 1, 2, 4, 5, 3)
    kk = k * k * cin
    if w_cols.shape[1] == kk:
        cols = taps.reshape(n * ho * wo, kk)
    else:
        cols = q.new_zeros((n * ho * wo, w_cols.shape[1]))
        cols[:, :kk].view(n, ho, wo, k, k, cin).copy_(taps)
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
        LAUNCHES["int8_epilogue"] += 1
        LAUNCHES["int8_epilogue_int8" if inv is not None
                 else "int8_epilogue_f32"] += 1
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
