"""D1: the bilinear sampling of the deformable convolution (DCNv1).

Port of the TPU-shaped op ``_bilinear_sample`` of
``db_text_minimal_tpu/models/deform.py:24-51`` and the tap loop around it in
``DeformConv.__call__`` (:61-98). Two kernels written by hand in CUDA for
Hopper (``csrc/deform.cu``) carry it:

- ``deform_im2col`` (the forward): each of the 9 taps samples the NHWC
  input bilinearly at its offset coordinates, in f32, and writes the
  sample in the compute dtype: the columns (9, N·OH·OW, C);
- ``deform_col2im`` (the backward): from the columns' gradient, the input
  gradient (a scatter of the four corner weights, by atomics) and the
  offsets' gradient (a reduction over C per pixel and tap).

Both are registered as custom ops, ``dbtext::deform_im2col`` and
``dbtext::deform_col2im``, each with a fake (so that ``torch.export``
traces them and an archive holds them), and the first with the second as
its gradient. ``deform_conv`` is the whole conv: the columns, then the 9
per-tap 1×1 products by ``torch.matmul`` in the compute dtype, summed in
tap order (``out = out + cols[t] @ W_t``), as the JAX module and XLA
compute them: one K = 9C product would round the bf16 sum once, and so
differently than flax. Autograd takes the products back
(``grad_cols[t] = g @ W_tᵀ``, ``dW_t = cols[t]ᵀ @ g`` in the compute
dtype), with the columns kept from the forward for ``dW``, not
recomputed, and then calls ``deform_col2im``.

The sampling follows the JAX arithmetic: the coordinate is ``(base + (k -
1)) + d``, then ``floor``; each corner has its own validity and its index
clamped into the image; every product and sum of the blend is rounded on
its own. At an integer coordinate (every sample at init, where the offsets
are zero) the lower corner's weight is 1 and the offset gradient is the
difference towards the next row or column, as ``jax.grad`` through
``floor`` gives it. ``F.grid_sample`` is not used: its unnormalising
arithmetic moves some integer coordinates below themselves, where the
one-sided gradient takes the other side.

On CUDA tensors the ops launch their kernels, count each launch in
``LAUNCHES`` and raise if a kernel does not build or launch; on CPU tensors
they run the plain versions beside them, ``deform_im2col_plain`` and
``deform_col2im_plain`` (the backward written out, not by autograd), which
the CPU tests hold to the JAX functions.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ._native import CSRC, build_library, check_launch, on_cuda, stream_of

LAUNCHES = {"deform_im2col": 0, "deform_col2im": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_library() -> ctypes.CDLL:
    """Build ``csrc/deform.cu`` (first call only) and bind its C entries."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library(os.path.join(CSRC, "deform.cu"),
                                            "libdeform", "cuda"))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.deform_im2col.argtypes = [p, i, p, p, i] + [i] * 8 + [p]
            lib.deform_col2im.argtypes = [p, i, p, p, i, p, p] + [i] * 8 + [p]
            lib.deform_im2col.restype = ctypes.c_int
            lib.deform_col2im.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def out_size(size: int, stride: int) -> int:
    """The output size of a padding-1 3×3 conv at ``stride``."""
    return (size + stride - 1) // stride


# ------------------------------------------------------------ plain ----

def _coords(offsets: torch.Tensor, stride: int):
    """The sampling coordinates (y, x) of the 9 taps, each (9, N, OH, OW)
    f32, from ``offsets`` (N, OH, OW, 18): ``(base + (k - 1)) + d``."""
    n, oh, ow, _ = offsets.shape
    dev = offsets.device
    k = torch.arange(3, device=dev, dtype=torch.float32) - 1
    base_y = torch.arange(oh, device=dev, dtype=torch.float32) * stride
    base_x = torch.arange(ow, device=dev, dtype=torch.float32) * stride
    tap_y = base_y[None, :] + k.repeat_interleave(3)[:, None]   # (9, OH)
    tap_x = base_x[None, :] + k.repeat(3)[:, None]              # (9, OW)
    d = offsets.reshape(n, oh, ow, 9, 2).permute(3, 4, 0, 1, 2)
    return tap_y[:, None, :, None] + d[:, 0], tap_x[:, None, None, :] + d[:, 1]


def _corners(flat: torch.Tensor, n: int, h: int, w: int, y: torch.Tensor,
             x: torch.Tensor):
    """Bilinear corners of the NHWC image whose (N·H·W, C) rows are
    ``flat`` at the float coordinates (y, x) of shape (..., N, OH, OW):
    the fractions (wy, wx), each (..., N, OH, OW, 1), and per corner
    (v00, v01, v10, v11) its row index and validity, each (..., N, OH, OW),
    and its values (..., N, OH, OW, C), zero outside the image."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    image = (torch.arange(n, device=flat.device) * (h * w))[:, None, None]
    corners = []
    for yy, xx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        row = (image + yy.clamp(0, h - 1).long() * w
               + xx.clamp(0, w - 1).long())
        row = torch.where(valid, row, 0)     # a NaN coordinate reads row 0
        vals = flat[row.reshape(-1)].reshape(*row.shape, -1)
        corners.append((row, valid, torch.where(valid[..., None], vals, 0.0)))
    return (y - y0)[..., None], (x - x0)[..., None], corners


def _bilinear_sample(flat, n, h, w, y, x) -> torch.Tensor:
    """Sample the image whose (N·H·W, C) rows are ``flat`` at (y, x), each
    (N, OH, OW); returns (N, OH, OW, C) f32. Reads outside the image are
    zero."""
    wy, wx, ((_, _, v00), (_, _, v01), (_, _, v10), (_, _, v11)) = \
        _corners(flat, n, h, w, y, x)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def deform_im2col_plain(x: torch.Tensor, offsets: torch.Tensor, stride: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``deform_im2col``: the columns (9, N·OH·OW, C) in
    ``dtype`` of NHWC ``x`` sampled at ``offsets`` (N, OH, OW, 18), one
    tap at a time as the JAX module samples them."""
    n, h, w, c = x.shape
    flat = x.float().reshape(-1, c)
    y, xs = _coords(offsets.float(), stride)
    return torch.stack([_bilinear_sample(flat, n, h, w, y[t], xs[t])
                        for t in range(9)]).reshape(9, -1, c).to(dtype)


def deform_col2im_plain(x: torch.Tensor, offsets: torch.Tensor,
                        gcols: torch.Tensor, stride: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``deform_col2im``: from the columns' gradient
    ``gcols`` (9, N·OH·OW, C), the gradient of NHWC ``x`` (in x's dtype)
    and of ``offsets`` (N, OH, OW, 18, f32), written out as ``jax.grad``
    gives them through the sampling."""
    n, h, w, c = x.shape
    _, oh, ow, _ = offsets.shape
    flat = x.float().reshape(-1, c)
    y, xs = _coords(offsets.float(), stride)
    wy, wx, corners = _corners(flat, n, h, w, y, xs)
    (_, _, v00), (_, _, v01), (_, _, v10), (_, _, v11) = corners
    g = gcols.float().reshape(9, n, oh, ow, c)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    gt, gb = g * (1 - wy), g * wy
    dwy = (g * (bot - top)).sum(-1)
    dwx = (gt * (v01 - v00) + gb * (v11 - v10)).sum(-1)
    dx = torch.zeros_like(flat)
    for (row, valid, _), weight in zip(corners, (gt * (1 - wx), gt * wx,
                                                 gb * (1 - wx), gb * wx)):
        dx.index_add_(0, row.reshape(-1),
                      torch.where(valid[..., None], weight, 0.0).reshape(-1,
                                                                         c))
    doffsets = torch.stack([dwy, dwx], -1).permute(1, 2, 3, 0, 4)
    return (dx.reshape(n, h, w, c).to(x.dtype),
            doffsets.reshape(n, oh, ow, 18).contiguous())


# ---------------------------------------------------------- kernels ----

def _check(x: torch.Tensor, offsets: torch.Tensor, stride: int) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise TypeError(f"x must be f32 or bf16 (N, H, W, C), got {x.dtype} "
                        f"{tuple(x.shape)}")
    n, h, w, _ = x.shape
    want = (n, out_size(h, stride), out_size(w, stride), 18)
    if offsets.dtype != torch.float32 or tuple(offsets.shape) != want:
        raise TypeError(f"offsets must be f32 {want}, got {offsets.dtype} "
                        f"{tuple(offsets.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be positive, got {stride}")
    if not (x.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("the deformable sampling takes contiguous tensors")
    if max(n * h * w, offsets.shape[0] * want[1] * want[2]) >= 2 ** 31:
        raise ValueError("the kernels index pixels in 32 bits")


def _vec(c: int, *tensors: torch.Tensor) -> int:
    """4 channels a lane where C and every pointer allow it, else 1."""
    return 4 if c % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in tensors) else 1


@torch.library.custom_op("dbtext::deform_im2col", mutates_args=())
def _im2col_op(x: torch.Tensor, offsets: torch.Tensor, stride: int,
               dtype: torch.dtype) -> torch.Tensor:
    """The CPU implementation: the plain version."""
    return deform_im2col_plain(x, offsets, stride, dtype)


@_im2col_op.register_kernel("cuda")
def _im2col_cuda(x, offsets, stride, dtype):
    """The CUDA implementation: D1's forward kernel, or a raise."""
    on_cuda(x, offsets)
    n, h, w, c = x.shape
    _, oh, ow, _ = offsets.shape
    cols = torch.empty((9, n * oh * ow, c), dtype=dtype, device=x.device)
    err = load_library().deform_im2col(
        x.data_ptr(), int(x.dtype == torch.bfloat16), offsets.data_ptr(),
        cols.data_ptr(), int(dtype == torch.bfloat16), n, h, w, c, oh, ow,
        stride, _vec(c, x, cols), stream_of(x))
    check_launch(err, "deform_im2col")
    if cols.numel():
        LAUNCHES["deform_im2col"] += 1
    return cols


@_im2col_op.register_fake
def _im2col_fake(x, offsets, stride, dtype):
    n, oh, ow, _ = offsets.shape
    return x.new_empty((9, n * oh * ow, x.shape[3]), dtype=dtype)


@torch.library.custom_op("dbtext::deform_col2im", mutates_args=())
def _col2im_op(x: torch.Tensor, offsets: torch.Tensor, gcols: torch.Tensor,
               stride: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The CPU implementation: the plain version."""
    return deform_col2im_plain(x, offsets, gcols, stride)


@_col2im_op.register_kernel("cuda")
def _col2im_cuda(x, offsets, gcols, stride):
    """The CUDA implementation: D1's backward kernel, or a raise."""
    on_cuda(x, offsets, gcols)
    n, h, w, c = x.shape
    _, oh, ow, _ = offsets.shape
    dx = torch.zeros((n, h, w, c), dtype=torch.float32, device=x.device)
    doffsets = torch.empty_like(offsets)
    err = load_library().deform_col2im(
        x.data_ptr(), int(x.dtype == torch.bfloat16), offsets.data_ptr(),
        gcols.data_ptr(), int(gcols.dtype == torch.bfloat16), dx.data_ptr(),
        doffsets.data_ptr(), n, h, w, c, oh, ow, stride,
        _vec(c, x, gcols, dx), stream_of(x))
    check_launch(err, "deform_col2im")
    if doffsets.numel():
        LAUNCHES["deform_col2im"] += 1
    return dx.to(x.dtype), doffsets


@_col2im_op.register_fake
def _col2im_fake(x, offsets, gcols, stride):
    return torch.empty_like(x), torch.empty_like(offsets)


def _im2col_setup(ctx, inputs, output):
    x, offsets, stride, _ = inputs
    ctx.stride = stride
    ctx.save_for_backward(x, offsets)


def _im2col_backward(ctx, gcols):
    if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
        return None, None, None, None
    x, offsets = ctx.saved_tensors
    dx, doffsets = deform_col2im(x, offsets, gcols.contiguous(), ctx.stride)
    return dx, doffsets, None, None


_im2col_op.register_autograd(_im2col_backward, setup_context=_im2col_setup)


def deform_im2col(x: torch.Tensor, offsets: torch.Tensor, stride: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """The 9 taps' bilinear samples of NHWC ``x`` (f32 or bf16) at the f32
    ``offsets`` (N, OH, OW, 18): the columns (9, N·OH·OW, C) in ``dtype``
    (f32 or bf16), differentiable in ``x`` and ``offsets`` by
    ``deform_col2im``. Dispatches to the custom op ``dbtext::deform_im2col``:
    its kernel on CUDA tensors, its plain version on CPU ones."""
    _check(x, offsets, stride)
    if dtype not in _DTYPES:
        raise TypeError(f"the columns are f32 or bf16, not {dtype}")
    on_cuda(x, offsets)
    return torch.ops.dbtext.deform_im2col(x, offsets, stride, dtype)


def deform_col2im(x: torch.Tensor, offsets: torch.Tensor,
                  gcols: torch.Tensor, stride: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``deform_im2col``'s input and offsets from the
    columns' gradient ``gcols`` (9, N·OH·OW, C), f32 or bf16: (dx in x's
    dtype, doffsets f32). Dispatches to the custom op
    ``dbtext::deform_col2im``: its kernel on CUDA tensors (dx summed by
    atomics in f32, so its order varies from run to run), its plain version
    on CPU ones."""
    _check(x, offsets, stride)
    n, h, w, c = x.shape
    _, oh, ow, _ = offsets.shape
    if (gcols.dtype not in _DTYPES
            or tuple(gcols.shape) != (9, n * oh * ow, c)):
        raise TypeError(f"gcols must be f32 or bf16 (9, {n * oh * ow}, {c}), "
                        f"got {gcols.dtype} {tuple(gcols.shape)}")
    on_cuda(x, offsets, gcols)
    return torch.ops.dbtext.deform_col2im(x, offsets, gcols.contiguous(),
                                          stride)


# --------------------------------------------------------- the conv ----

def _taps(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The (F, C, 3, 3) kernel as 9 per-tap (C, F) matrices in ``dtype``."""
    f, c = weight.shape[:2]
    return weight.permute(2, 3, 1, 0).reshape(9, c, f).to(dtype)


def deform_conv(x: torch.Tensor, offsets: torch.Tensor,
                weight: torch.Tensor, stride: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The deformable 3×3 conv (padding 1) of NHWC ``x`` (N, H, W, C) with
    ``offsets`` (N, OH, OW, 18) and the kernel ``weight`` (F, C, 3, 3):
    (N, OH, OW, F) in ``dtype``, differentiable in all three. The sampling
    runs in f32 by ``deform_im2col`` and ``deform_col2im`` (kernels on CUDA
    tensors, plain versions on CPU ones); the per-tap products in
    ``dtype``, summed in tap order."""
    cols = deform_im2col(x.contiguous(), offsets.contiguous(), stride,
                         dtype).unbind(0)
    taps = _taps(weight, dtype).unbind(0)
    out = cols[0] @ taps[0]
    for t in range(1, 9):
        out = out + cols[t] @ taps[t]
    n, oh, ow, _ = offsets.shape
    return out.reshape(n, oh, ow, -1)
