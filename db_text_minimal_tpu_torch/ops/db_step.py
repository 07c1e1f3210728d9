"""The DB step: B̂ = σ(k(P − T)) and the bitmap P > thresh (kernels K1, K2).

Port of ``db_text_minimal_tpu/ops/pallas/db_step.py``:

- K1 ``fused_db_step`` (:54): B̂ and the f32 bitmap of (N, H, W) maps in one
  pass. No path of the package calls it; it is kept with its kernel.
- K2 ``db_step`` (:100-119): the training forward of the DB head, as a
  ``torch.autograd.Function``. Its forward saves only B̂, the JAX residual
  (:109-111); its backward writes dP = g·(k·B̂·(1−B̂)) and dT = −dP in one
  pass (:114-116).

The kernels are Triton (``db_step_triton.py``). Each wrapper launches its
kernel on a CUDA tensor, counts the launch in ``LAUNCHES`` and lets any
compile or launch error propagate; on a CPU tensor it runs the plain PyTorch
version beside it, whose rounding order is the JAX code's.
"""

from __future__ import annotations

import torch

from ._native import on_cuda

LAUNCHES = {"fused_db_step": 0, "db_step_forward": 0, "db_step_backward": 0}


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


def _launch(kernel: str, device: torch.device, n: int, *args) -> None:
    """Launch Triton kernel ``kernel`` of ``db_step_triton`` over ``n``
    elements on ``device``'s current stream."""
    from .db_step_triton import BLOCK, NUM_WARPS, kernels

    kern = kernels()
    with torch.cuda.device(device):
        getattr(kern, kernel)[(kern.cdiv(n, BLOCK),)](
            *args, BLOCK=BLOCK, num_warps=NUM_WARPS)


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
