"""Deformable convolution (DCNv1): its offset branch and the D1 sampling.

Counterpart of ``db_text_minimal_tpu/models/deform.py``: a 3×3 conv whose 9
sampling locations are shifted per output pixel by learned offsets (18
channels = 9 taps × (dy, dx), row-major over the taps), out-of-image reads
zero, padding 1 and an optional stride. The deformable ResNets' conv2
(``models/resnet``) is one.

The sampling is D1, ``ops/deform.deform_conv``: the 9 taps' bilinear
samples of the input in float32 (hand-written CUDA kernels on the card, in
the forward and the backward; their plain versions on the CPU), then the
per-tap products summed in ``compute_dtype`` (flax's ``dtype``;
``DBTextModel`` sets it). The offset conv runs in float32 in every compute
dtype, as in JAX, where offsets are sampling coordinates.

The kernel is ``weight`` of shape (F, C, 3, 3), the state_dict layout of a
conv; ``offset_conv`` is a 3×3 conv to 18 channels with a bias, at the
block's stride, zero at init (``layers.init_weights``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.deform import deform_conv


class DeformConv(nn.Module):
    """3×3 deformable conv, padding 1, optional stride. NCHW in, NCHW
    (channels-last) out in ``compute_dtype``, of size ⌈H/stride⌉ ×
    ⌈W/stride⌉."""

    compute_dtype = torch.float32

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.offset_conv = nn.Conv2d(in_channels, 18, 3, stride=stride,
                                     padding=1, bias=True)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               3, 3))
        nn.init.kaiming_normal_(self.weight, mode="fan_out",
                                nonlinearity="relu")
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        offsets = self.offset_conv(xf)               # (N, 18, OH, OW)
        out = deform_conv(xf.permute(0, 2, 3, 1), offsets.permute(0, 2, 3, 1),
                          self.weight, self.stride, self.compute_dtype)
        return out.permute(0, 3, 1, 2)
