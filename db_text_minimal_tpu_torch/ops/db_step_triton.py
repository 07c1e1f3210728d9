"""Triton kernels for Hopper: the DB step maps K1 and K2 (forward, backward),
and the DB head's train-mode tail that replaces K2 on the training path.

Replaces ``db_text_minimal_tpu/ops/pallas/db_step.py``: K1 ``_fused_tpu`` +
``_kernel`` (:27-51) and K2 ``_bhat_tpu`` + ``_bhat_kernel`` (:71-87) with
the analytic backward of ``_db_step_bwd`` (:114-116), which XLA fused into
the rest of the backward pass and the port writes as a kernel of its own.

All three are elementwise passes over f32 maps: a single read of each input
and a single write of each output, no reuse, no tensor cores. Each is bound
by device memory bytes (K1 16 B, K2 forward 12 B, K2 backward 16 B per
pixel), so the design is a 1-D block of ``BLOCK`` consecutive elements per
program, which gives each thread 128-bit loads of neighbouring addresses. The
TPU's 256- and 512-row VMEM blocks have no counterpart: there is nothing to
stage. The backward reads its incoming gradient at a uniform element stride,
because the loss reads B̂ as the last channel of an NHWC view and autograd
hands the gradient over at stride 3; a copy to make it contiguous would be a
second pass.

This module imports without Triton: ``kernels()`` imports it and compiles
the kernels at the first launch, on the machine with the card. The kernel
bodies below are plain functions until then; ``tl``, ``libdevice`` and the
jitted ``_sigmoid_torch`` are bound into this module's globals by
``kernels()``, which is where Triton's compiler resolves them.

The DB head's train-mode tail (``db_tail``) replaces K2 on the training
path: one forward pass from the two branches' last deconv outputs (bf16 or
f32, 4 or 8 B a pixel) to the (N, H, W, 3) f32 output (P, T, B̂), 12 B a
pixel, where the composition it replaces (two casts, two sigmoids, K2 and
the concatenation) moved about 60 B a pixel in 6 launches; and one backward
pass from the output's gradient (all 12 B a pixel, at the strides autograd
hands it over) and the saved inputs, recomputing P, T and B̂, to dzb and
dzt in the inputs' dtype. Bound by bytes, as K2: no reuse, no products.
The sigmoids of P and T are torch's (libdevice ``expf``, IEEE division) and
B̂'s is K2's, and the backward takes the operations of the composition's
autograd in their order, compiled without fused multiply-adds, so that the
tail gives the composition's values bit for bit. The forward gives each
thread one output float rather than one pixel: whole-sector stores in
place of three stores a pixel at a stride of 12 B, which measured 1.6×
slower on the card (PERF.md §6).
"""

import threading
from types import SimpleNamespace

BLOCK = 1024
NUM_WARPS = 4

_LOCK = threading.Lock()
_KERNELS = None


def _fused_db_step_kernel(p_ptr, t_ptr, bhat_ptr, bitmap_ptr, n_elements,
                          k, thresh, BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)  # noqa: F821
    mask = offs < n_elements
    p = tl.load(p_ptr + offs, mask=mask, other=0.0)  # noqa: F821
    t = tl.load(t_ptr + offs, mask=mask, other=0.0)  # noqa: F821
    x = k * (p - t)
    tl.store(bhat_ptr + offs, 1.0 / (1.0 + tl.exp(-x)),  # noqa: F821
             mask=mask)
    tl.store(bitmap_ptr + offs, (p > thresh).to(tl.float32),  # noqa: F821
             mask=mask)


def _db_step_fwd_kernel(p_ptr, t_ptr, bhat_ptr, n_elements, k,
                        BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)  # noqa: F821
    mask = offs < n_elements
    p = tl.load(p_ptr + offs, mask=mask, other=0.0)  # noqa: F821
    t = tl.load(t_ptr + offs, mask=mask, other=0.0)  # noqa: F821
    x = k * (p - t)
    tl.store(bhat_ptr + offs, 1.0 / (1.0 + tl.exp(-x)),  # noqa: F821
             mask=mask)


def _db_step_bwd_kernel(g_ptr, bhat_ptr, dp_ptr, dt_ptr, n_elements,
                        g_stride, k, BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)  # noqa: F821
    mask = offs < n_elements
    g = tl.load(g_ptr + offs * g_stride, mask=mask, other=0.0)  # noqa: F821
    b = tl.load(bhat_ptr + offs, mask=mask, other=0.0)  # noqa: F821
    dp = g * (k * b * (1.0 - b))       # the JAX rounding order
    tl.store(dp_ptr + offs, dp, mask=mask)  # noqa: F821
    tl.store(dt_ptr + offs, -dp, mask=mask)  # noqa: F821


def _sigmoid_torch(z):
    """torch's float sigmoid, 1 / (1 + expf(-z)) with an IEEE division."""
    return tl.math.div_rn(1.0, 1.0 + libdevice.exp(-z))  # noqa: F821


def _db_tail_fwd_kernel(zb_ptr, zt_ptr, out_ptr, n_out, k,
                        BLOCK: "tl.constexpr"):
    # a thread an element of the (N, H, W, 3) output: BLOCK consecutive
    # floats a program, so the stores are whole sectors; the three threads
    # of a pixel read its inputs (the second and third from L1) and each
    # computes all three maps
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)  # noqa: F821
    mask = offs < n_out
    pixel = offs // 3
    channel = offs - 3 * pixel
    zb = tl.load(zb_ptr + pixel, mask=mask, other=0.0)  # noqa: F821
    zt = tl.load(zt_ptr + pixel, mask=mask, other=0.0)  # noqa: F821
    p = _sigmoid_torch(zb.to(tl.float32))  # noqa: F821
    t = _sigmoid_torch(zt.to(tl.float32))  # noqa: F821
    x = k * (p - t)
    b = 1.0 / (1.0 + tl.exp(-x))       # K2's  # noqa: F821
    tl.store(out_ptr + offs,  # noqa: F821
             tl.where(channel == 0, p,  # noqa: F821
                      tl.where(channel == 1, t, b)),  # noqa: F821
             mask=mask)


def _db_tail_bwd_kernel(g_ptr, zb_ptr, zt_ptr, dzb_ptr, dzt_ptr, n_elements,
                        g_stride, g_channel, k, BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)  # noqa: F821
    mask = offs < n_elements
    g = g_ptr + offs * g_stride
    gp = tl.load(g, mask=mask, other=0.0)  # noqa: F821
    gt = tl.load(g + g_channel, mask=mask, other=0.0)  # noqa: F821
    gb = tl.load(g + 2 * g_channel, mask=mask, other=0.0)  # noqa: F821
    zb = tl.load(zb_ptr + offs, mask=mask, other=0.0)  # noqa: F821
    zt = tl.load(zt_ptr + offs, mask=mask, other=0.0)  # noqa: F821
    p = _sigmoid_torch(zb.to(tl.float32))  # noqa: F821
    t = _sigmoid_torch(zt.to(tl.float32))  # noqa: F821
    x = k * (p - t)
    b = 1.0 / (1.0 + tl.exp(-x))  # noqa: F821
    d = gb * (k * b * (1.0 - b))       # K2's backward, the JAX order
    # autograd sums the two gradients of P (of T) and then takes torch's
    # sigmoid backward, g·(1 − σ)·σ
    dzb = (gp + d) * (1.0 - p) * p
    dzt = (gt + (-d)) * (1.0 - t) * t
    tl.store(dzb_ptr + offs, dzb.to(dzb_ptr.dtype.element_ty),  # noqa: F821
             mask=mask)
    tl.store(dzt_ptr + offs, dzt.to(dzt_ptr.dtype.element_ty),  # noqa: F821
             mask=mask)


def _libdevice():
    """Triton's libdevice module, wherever this Triton keeps it."""
    try:
        from triton.language.extra.cuda import libdevice
    except ImportError:
        from triton.language.extra import libdevice
    return libdevice


def kernels() -> SimpleNamespace:
    """Import Triton and wrap the five kernels with ``triton.jit`` (first
    call only). Triton compiles each for the card at its first launch."""
    global _KERNELS
    with _LOCK:
        if _KERNELS is None:
            import triton
            import triton.language as tl

            globals()["tl"] = tl
            globals()["libdevice"] = _libdevice()
            sigmoid = triton.jit(_sigmoid_torch)
            globals()["_sigmoid_torch"] = sigmoid
            _KERNELS = SimpleNamespace(
                cdiv=triton.cdiv,
                fused=triton.jit(_fused_db_step_kernel),
                forward=triton.jit(_db_step_fwd_kernel),
                backward=triton.jit(_db_step_bwd_kernel),
                tail_forward=triton.jit(_db_tail_fwd_kernel),
                tail_backward=triton.jit(_db_tail_bwd_kernel))
    return _KERNELS
