"""Triton kernels for Hopper: the DB step maps K1 and K2 (forward, backward).

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
bodies below are plain functions until then; ``tl`` is bound into this
module's globals by ``kernels()``, which is where Triton's compiler resolves
it.
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


def kernels() -> SimpleNamespace:
    """Import Triton and wrap the three kernels with ``triton.jit`` (first
    call only). Triton compiles each for the card at its first launch."""
    global _KERNELS
    with _LOCK:
        if _KERNELS is None:
            import triton
            import triton.language as tl

            globals()["tl"] = tl
            _KERNELS = SimpleNamespace(
                cdiv=triton.cdiv,
                fused=triton.jit(_fused_db_step_kernel),
                forward=triton.jit(_db_step_fwd_kernel),
                backward=triton.jit(_db_step_bwd_kernel))
    return _KERNELS
