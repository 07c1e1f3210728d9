"""Shared model building blocks and resize primitives.

Counterpart of ``db_text_minimal_tpu/models/layers.py``. Modules work in
NCHW inside; the model's public functions keep the JAX package's NHWC.
Batch norm: flax ``momentum=0.9`` is torch ``momentum=0.1``, eps 1e-5, and
in train mode flax's running-statistics rule (see ``BatchNorm2d``).

Compute dtype, as flax's ``dtype`` field: ``Conv2d`` and
``ConvTranspose2d`` cast their input, weight and bias to their
``compute_dtype`` (float32 unless ``DBTextModel`` sets bfloat16) and hand
their output on in it; ``BatchNorm2d`` computes in float32 and hands float32
on, as every flax BN of the model does (``dtype=jnp.float32``). Parameters,
buffers and gradients stay float32. In float32 every cast is a no-op.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .deform import DeformConv


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm with flax's running-statistics rule.

    Train mode normalises with the batch mean and the biased batch variance,
    as both frameworks do, and then moves the running mean and variance by
    momentum 0.1 towards the batch mean and the **biased** variance, as
    flax's ``BatchNorm`` does; ``nn.BatchNorm2d`` would take the unbiased
    one, n/(n−1) larger. Eval mode is ``nn.BatchNorm2d``'s. The state_dict
    keys are ``nn.BatchNorm2d``'s. A bfloat16 input is taken to float32
    first, and the output is float32.

    With a ``process_group`` (set by ``parallel.wrap_model``) train mode
    takes the statistics of every process's batch together, as the JAX
    trainer's batch norm over a global batch split across hosts: the
    per-channel sums of x and x² summed over the processes
    (differentiably), the variance E[x²] − E[x]²."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            return self._forward_global(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self._update_running(mean, var)
        return y

    def _update_running(self, mean, var) -> None:
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked.add_(1)

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel import all_reduce_sum

        count = torch.tensor(float(x.numel() // x.shape[1]),
                             device=x.device)
        sums = all_reduce_sum(torch.stack([x.sum(dim=(0, 2, 3)),
                                           (x * x).sum(dim=(0, 2, 3))]))
        count = all_reduce_sum(count)
        mean = sums[0] / count
        var = (sums[1] / count - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self._update_running(mean, var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x * scale[:, None, None]
                + (self.bias - mean * scale)[:, None, None])


def _add_bias(y: torch.Tensor, bias, dtype: torch.dtype) -> torch.Tensor:
    # flax adds the bias to the rounded conv output, in the compute dtype
    return y if bias is None else y + bias.to(dtype)[:, None, None]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in ``compute_dtype`` (flax ``nn.Conv(dtype=...)``):
    the input and weight cast to it, the output in it, the bias cast to it
    and added after the conv as flax adds it. In float32, ``nn.Conv2d``."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == self.weight.dtype:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return _add_bias(y, self.bias, dt)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in ``compute_dtype`` (flax
    ``nn.ConvTranspose(dtype=...)``), as ``Conv2d``."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == self.weight.dtype:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding, self.output_padding,
                               self.groups, self.dilation)
        return _add_bias(y, self.bias, dt)


class Sigmoid32(nn.Module):
    """σ in float32 of a map in any dtype, as the flax head's
    ``nn.sigmoid(x.astype(jnp.float32))``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x.float())


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ConvBnRelu(nn.Module):
    """conv + batch-norm + relu, with the conv's bias as the FPN uses it."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, padding: int = 0):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           padding=padding)
        self.bn = batch_norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _power_of_two_up(size: int, out: int) -> bool:
    ratio, rest = divmod(out, size)
    return rest == 0 and ratio & (ratio - 1) == 0


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW nearest resize, src index = floor(dst · in / out) in integers,
    as the JAX ``resize_nearest``. ``F.interpolate`` computes the index
    from a float32 scale, exact when out/in is a power of two (every
    resize of a 640² canvas) and one row low at some other ratios (6 to
    74, 14 to 46), so those take the integer indices."""
    h, w = x.shape[-2:]
    oh, ow = size
    if (h, w) == (oh, ow):
        return x
    if _power_of_two_up(h, oh) and _power_of_two_up(w, ow):
        return F.interpolate(x, size=(oh, ow), mode="nearest")
    rows = torch.arange(oh, device=x.device) * h // oh
    cols = torch.arange(ow, device=x.device) * w // ow
    return x[:, :, rows][:, :, :, cols]


def resize_bilinear_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW bilinear resize with ``align_corners=True``."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def _kaiming_fan_out(weight: torch.Tensor, fan_out: int,
                     generator: torch.Generator) -> None:
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator,
                 head_bn_bias: float = 0.0) -> None:
    """Seeded init of every conv and BN in ``module``: Kaiming-normal
    (fan_out, relu) kernels, the depthwise convs' (fan_out = 9 · C, as
    flax counts it) and the deformable convs' (``DeformConv``) included,
    zero conv biases, BN weight 1 and bias ``head_bn_bias`` (1e-4 in the
    DB head). A deformable conv's offset branch starts at zero, weights
    and bias (JAX deform.py:66-75)."""
    offset_convs = set()
    for m in module.modules():
        if isinstance(m, DeformConv):
            _kaiming_fan_out(m.weight, m.weight.shape[0] * 9, generator)
            with torch.no_grad():
                m.offset_conv.weight.zero_()
                m.offset_conv.bias.zero_()
            offset_convs.add(m.offset_conv)
        elif m in offset_convs:
            continue
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_out = (m.weight.shape[1] if isinstance(m, nn.ConvTranspose2d)
                       else m.weight.shape[0])
            fan_out *= m.weight.shape[2] * m.weight.shape[3]
            _kaiming_fan_out(m.weight, fan_out, generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.fill_(head_bn_bias)
