"""The DB step: B̂ = σ(k(P − T)) and the bitmap P > thresh (kernels K1, K2).

Port of ``db_text_minimal_tpu/ops/pallas/db_step.py``:

- K1 ``fused_db_step`` (:54): B̂ and the f32 bitmap of (N, H, W) maps in one
  pass. No path of the package calls it; it is kept with its kernel.
- K2 ``db_step`` (:100-119): the training forward of the DB head, as a
  ``torch.autograd.Function``. Its forward saves only B̂, the JAX residual
  (:109-111); its backward writes dP = g·(k·B̂·(1−B̂)) and dT = −dP in one
  pass (:114-116).

The DB head's train-mode tail, ``db_tail`` (a ``torch.autograd.Function``),
takes K2's place on the training path (JAX ``models/head.py:54-57,76-84``
with the VJP of ``ops/pallas/db_step.py:100-119``): from the two branches'
last deconv outputs zb and zt, (N, 1, H, W) in the compute dtype, one
forward launch writes the (N, H, W, 3) f32 output [σ(zb), σ(zt),
σ(k(σ(zb) − σ(zt)))], returned as the (N, 3, H, W) view that the
concatenation gave; one backward launch reads the output's gradient at its
strides and writes dzb = (gP + gB·k·B̂(1−B̂))·P(1−P) and dzt = (gT −
gB·k·B̂(1−B̂))·T(1−T) in the inputs' dtype, recomputing P, T and B̂ from the
saved zb and zt. Its plain version, ``db_tail_plain``, is the composition it
replaces: two float32 casts and sigmoids, K2 (``db_step``) and the
concatenation. K1 and K2 stay as the per-op counterparts of JAX's
functions; no path of the package calls them now.

The kernels are Triton (``db_step_triton.py``). Each wrapper launches its
kernel on a CUDA tensor, counts the launch in ``LAUNCHES`` and lets any
compile or launch error propagate; on a CPU tensor it runs the plain PyTorch
version beside it, whose rounding order is the JAX code's.
"""

from __future__ import annotations

import torch

from ._native import on_cuda

LAUNCHES = {"fused_db_step": 0, "db_step_forward": 0, "db_step_backward": 0,
            "db_tail_forward": 0, "db_tail_backward": 0}
TAIL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_maps(*tensors: torch.Tensor) -> None:
    shape = tensors[0].shape
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the DB step takes float32 maps, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"shapes differ: {tuple(t.shape)} and "
                             f"{tuple(shape)}")


def _contiguous(t: torch.Tensor, name: str) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous for the kernel")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernel "
                         f"indexes with int32")
    return t


def _launch(kernel: str, device: torch.device, n: int, *args,
            **options) -> None:
    """Launch Triton kernel ``kernel`` of ``db_step_triton`` over ``n``
    elements on ``device``'s current stream."""
    from .db_step_triton import BLOCK, NUM_WARPS, kernels

    kern = kernels()
    with torch.cuda.device(device):
        getattr(kern, kernel)[(kern.cdiv(n, BLOCK),)](
            *args, BLOCK=BLOCK, num_warps=NUM_WARPS, **options)


# ------------------------------------------------------------------ K1 ----

def fused_db_step_plain(prob: torch.Tensor, thresh_map: torch.Tensor,
                        k: float = 50.0, thresh: float = 0.3):
    return (torch.sigmoid(k * (prob - thresh_map)),
            (prob > thresh).to(torch.float32))


def fused_db_step(prob: torch.Tensor, thresh_map: torch.Tensor,
                  k: float = 50.0, thresh: float = 0.3):
    """(N, H, W) f32 prob and threshold maps -> (B̂, bitmap), both f32."""
    _check_maps(prob, thresh_map)
    if not on_cuda(prob, thresh_map):
        return fused_db_step_plain(prob, thresh_map, k, thresh)
    p = _contiguous(prob, "prob")
    t = _contiguous(thresh_map, "thresh_map")
    bhat, bitmap = torch.empty_like(p), torch.empty_like(p)
    _launch("fused", p.device, p.numel(), p, t, bhat, bitmap, p.numel(),
            float(k), float(thresh))
    LAUNCHES["fused_db_step"] += 1
    return bhat, bitmap


# ------------------------------------------------------------------ K2 ----

def db_step_forward_plain(p: torch.Tensor, t: torch.Tensor,
                          k: float = 50.0) -> torch.Tensor:
    return torch.sigmoid(k * (p - t))


def db_step_backward_plain(g: torch.Tensor, bhat: torch.Tensor,
                           k: float = 50.0):
    dp = g * (k * bhat * (1.0 - bhat))
    return dp, -dp


def db_step_forward(p: torch.Tensor, t: torch.Tensor,
                    k: float = 50.0) -> torch.Tensor:
    """K2 forward: B̂ = σ(k(P − T)) for contiguous f32 P and T."""
    _check_maps(p, t)
    if not on_cuda(p, t):
        return db_step_forward_plain(p, t, k)
    p, t = _contiguous(p, "P"), _contiguous(t, "T")
    bhat = torch.empty_like(p)
    _launch("forward", p.device, p.numel(), p, t, bhat, p.numel(), float(k))
    LAUNCHES["db_step_forward"] += 1
    return bhat


def uniform_stride(t: torch.Tensor) -> int | None:
    """The element stride s with ``t``'s i-th element (row-major) at
    ``data_ptr + i·s``, or None when the strides are not uniform."""
    stride, expected = None, None
    for size, st in reversed(list(zip(t.shape, t.stride()))):
        if size == 1:
            continue
        if stride is None:
            stride, expected = st, st * size
        elif st != expected:
            return None
        else:
            expected *= size
    return 1 if stride is None else stride


def db_step_backward(g: torch.Tensor, bhat: torch.Tensor, k: float = 50.0):
    """K2 backward: (dP, dT) = (g·k·B̂(1−B̂), −dP) in one pass. ``g`` may
    lie at any uniform element stride, as the gradient of the NHWC output's
    last channel does; other layouts are copied first."""
    _check_maps(g, bhat)
    if not on_cuda(g, bhat):
        return db_step_backward_plain(g, bhat, k)
    bhat = _contiguous(bhat, "B̂")
    stride = uniform_stride(g)
    if stride is None:
        g, stride = g.contiguous(), 1
    if g.numel() * stride >= 2 ** 31:
        raise ValueError("the gradient spans more than 2**31 elements")
    dp, dt = torch.empty_like(bhat), torch.empty_like(bhat)
    _launch("backward", bhat.device, bhat.numel(), g, bhat, dp, dt,
            bhat.numel(), stride, float(k))
    LAUNCHES["db_step_backward"] += 1
    return dp, dt


class _DBStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, t, k):
        bhat = db_step_forward(p, t, k)
        ctx.save_for_backward(bhat)
        ctx.k = k
        return bhat

    @staticmethod
    def backward(ctx, g):
        (bhat,) = ctx.saved_tensors
        dp, dt = db_step_backward(g, bhat, ctx.k)
        return dp, dt, None


def db_step(p: torch.Tensor, t: torch.Tensor, k: float = 50.0):
    """Differentiable binarization B̂ = σ(k(P − T)) through K2, forward and
    backward."""
    return _DBStep.apply(p, t, float(k))


# the plain version of ``db_step``: torch's autograd differentiates it
db_step_plain = db_step_forward_plain


# ------------------------------------------------------- the DB tail ----

def db_tail_plain(zb: torch.Tensor, zt: torch.Tensor,
                  k: float = 50.0) -> torch.Tensor:
    """The composition the tail replaces: σ of each branch in float32, K2
    and the concatenation, (N, 3, H, W); torch's autograd differentiates
    it (K2's backward is ``db_step``'s)."""
    shrink, threshold = torch.sigmoid(zb.float()), torch.sigmoid(zt.float())
    return torch.cat([shrink, threshold, db_step(shrink, threshold, k)],
                     dim=1)


def db_tail_backward_plain(g: torch.Tensor, zb: torch.Tensor,
                           zt: torch.Tensor, k: float = 50.0):
    """The gradients of ``db_tail_plain`` written out in the order of its
    autograd: K2's dP = gB·(k·B̂·(1 − B̂)), dT = −dP, each summed with the
    map's own gradient, then torch's sigmoid backward g·(1 − σ)·σ and the
    cast's back to the inputs' dtype."""
    p, t = torch.sigmoid(zb.float()), torch.sigmoid(zt.float())
    d = db_step_backward_plain(g[:, 2:3], db_step_forward_plain(p, t, k),
                               k)[0]
    dzb = (g[:, 0:1] + d) * (1.0 - p) * p
    dzt = (g[:, 1:2] + (-d)) * (1.0 - t) * t
    return dzb.to(zb.dtype), dzt.to(zt.dtype)


def _check_tail(zb: torch.Tensor, zt: torch.Tensor) -> None:
    if zb.dim() != 4 or zb.shape[1] != 1 or zb.shape != zt.shape:
        raise ValueError(f"the tail takes two (N, 1, H, W) maps, got "
                         f"{tuple(zb.shape)} and {tuple(zt.shape)}")
    if zb.dtype not in TAIL_DTYPES or zt.dtype != zb.dtype:
        raise TypeError(f"the tail takes float32 or bfloat16 maps of one "
                        f"dtype, got {zb.dtype} and {zt.dtype}")


def db_tail_forward(zb: torch.Tensor, zt: torch.Tensor,
                    k: float = 50.0) -> torch.Tensor:
    """The tail's forward: (N, 3, H, W) f32 (P, T, B̂), on CUDA tensors a
    view of one (N, H, W, 3) buffer written by one launch."""
    _check_tail(zb, zt)
    if not on_cuda(zb, zt):
        return db_tail_plain(zb, zt, k)
    zb, zt = zb.contiguous(), zt.contiguous()
    if 3 * zb.numel() >= 2 ** 31:
        raise ValueError("the tail's output has 2**31 elements or more")
    n, _, h, w = zb.shape
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=zb.device)
    _launch("tail_forward", zb.device, out.numel(), zb, zt, out, out.numel(),
            float(k))
    LAUNCHES["db_tail_forward"] += 1
    return out.permute(0, 3, 1, 2)


def db_tail_backward(g: torch.Tensor, zb: torch.Tensor, zt: torch.Tensor,
                     k: float = 50.0):
    """The tail's backward: (dzb, dzt) in the inputs' dtype from the
    output's (N, 3, H, W) f32 gradient ``g``, read at its strides where
    each channel's pixels lie at one uniform stride (the NHWC gradient of
    the train step: pixel stride 3, channel stride 1), else copied into
    that layout first."""
    _check_tail(zb, zt)
    if g.dtype != torch.float32 or g.shape != (zb.shape[0], 3,
                                                *zb.shape[2:]):
        raise TypeError(f"the gradient must be f32 of the output's shape, "
                        f"got {g.dtype} {tuple(g.shape)}")
    if not on_cuda(g, zb, zt):
        return db_tail_backward_plain(g, zb, zt, k)
    zb, zt = zb.contiguous(), zt.contiguous()
    stride = uniform_stride(g[:, 0])
    if stride is None:
        g = g.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
        stride = 3
    channel = g.stride(1)
    if zb.numel() * stride + 2 * channel >= 2 ** 31:
        raise ValueError("the gradient spans 2**31 elements or more")
    # in the layout the composition's autograd gives them (contiguous, not
    # the deconv output's channels-last strides): cuDNN picks the deconv's
    # backward by it, and so its rounding
    dzb = torch.empty(zb.shape, dtype=zb.dtype, device=zb.device)
    dzt = torch.empty_like(dzb)
    # no fused multiply-adds: gP + gB·(...) rounds as the composition's
    # two operations do
    _launch("tail_backward", zb.device, zb.numel(), g, zb, zt, dzb, dzt,
            zb.numel(), stride, channel, float(k), enable_fp_fusion=False)
    LAUNCHES["db_tail_backward"] += 1
    return dzb, dzt


class _DBTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, zb, zt, k):
        ctx.save_for_backward(zb, zt)
        ctx.k = k
        return db_tail_forward(zb, zt, k)

    @staticmethod
    def backward(ctx, g):
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return None, None, None
        zb, zt = ctx.saved_tensors
        dzb, dzt = db_tail_backward(g, zb, zt, ctx.k)
        return dzb, dzt, None


def db_tail(zb: torch.Tensor, zt: torch.Tensor, k: float = 50.0):
    """The DB head's train-mode output (N, 3, H, W) f32 = (σ(zb), σ(zt),
    σ(k(σ(zb) − σ(zt)))) from the branches' last deconv outputs, forward
    and backward one launch each on CUDA tensors (their plain versions on
    CPU ones)."""
    return _DBTail.apply(zb, zt, float(k))
