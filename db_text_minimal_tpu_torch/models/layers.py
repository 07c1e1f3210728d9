"""Shared model building blocks and resize primitives.

Counterpart of ``db_text_minimal_tpu/models/layers.py``. Modules work in
NCHW inside; the model's public functions keep the JAX package's NHWC.
Batch norm: flax ``momentum=0.9`` is torch ``momentum=0.1``, eps 1e-5, and
in train mode flax's running-statistics rule (see ``BatchNorm2d``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm with flax's running-statistics rule.

    Train mode normalises with the batch mean and the biased batch variance,
    as both frameworks do, and then moves the running mean and variance by
    momentum 0.1 towards the batch mean and the **biased** variance, as
    flax's ``BatchNorm`` does; ``nn.BatchNorm2d`` would take the unbiased
    one, n/(n−1) larger. Eval mode is ``nn.BatchNorm2d``'s. The state_dict
    keys are ``nn.BatchNorm2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return y


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ConvBnRelu(nn.Module):
    """conv + batch-norm + relu, with the conv's bias as the FPN uses it."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=padding)
        self.bn = batch_norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW nearest resize, src index = floor(dst · in / out)."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest")


def resize_bilinear_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW bilinear resize with ``align_corners=True``."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def init_weights(module: nn.Module, generator: torch.Generator,
                 head_bn_bias: float = 0.0) -> None:
    """Seeded init of every conv and BN in ``module``: Kaiming-normal
    (fan_out, relu) kernels, zero conv biases, BN weight 1 and bias
    ``head_bn_bias`` (1e-4 in the DB head)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_out = (m.weight.shape[1] if isinstance(m, nn.ConvTranspose2d)
                       else m.weight.shape[0])
            fan_out *= m.weight.shape[2] * m.weight.shape[3]
            with torch.no_grad():
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.fill_(head_bn_bias)
