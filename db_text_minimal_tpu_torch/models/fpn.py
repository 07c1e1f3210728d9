"""FPN neck.

Counterpart of ``db_text_minimal_tpu/models/fpn.py::FPN``: 1×1 reduce convs
to inner/4 channels, nearest-upsample top-down adds, 3×3 smooth convs,
upsample-all-and-concat at p2 scale, then a final 3×3 conv + BN + relu kept
as the ``nn.Sequential`` ``conv`` (keys ``conv.0``/``conv.1``). Convs
compute in their ``compute_dtype``, BNs in float32 (``layers``), so every
add and concat here is float32, as in flax.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv2d, ConvBnRelu, batch_norm, resize_nearest


class FPN(nn.Module):
    def __init__(self, in_channels=(64, 128, 256, 512),
                 inner_channels: int = 256):
        super().__init__()
        inner = inner_channels // 4
        c2, c3, c4, c5 = in_channels
        self.reduce_conv_c2 = ConvBnRelu(c2, inner, 1)
        self.reduce_conv_c3 = ConvBnRelu(c3, inner, 1)
        self.reduce_conv_c4 = ConvBnRelu(c4, inner, 1)
        self.reduce_conv_c5 = ConvBnRelu(c5, inner, 1)
        self.smooth_p4 = ConvBnRelu(inner, inner, 3, padding=1)
        self.smooth_p3 = ConvBnRelu(inner, inner, 3, padding=1)
        self.smooth_p2 = ConvBnRelu(inner, inner, 3, padding=1)
        self.conv = nn.Sequential(
            Conv2d(inner * 4, inner_channels, 3, padding=1),
            batch_norm(inner_channels), nn.ReLU(inplace=True))
        self.out_channels = inner_channels

    def forward(self, feats):
        c2, c3, c4, c5 = feats
        p5 = self.reduce_conv_c5(c5)
        p4 = self.smooth_p4(resize_nearest(p5, c4.shape[-2:])
                            + self.reduce_conv_c4(c4))
        p3 = self.smooth_p3(resize_nearest(p4, c3.shape[-2:])
                            + self.reduce_conv_c3(c3))
        p2 = self.smooth_p2(resize_nearest(p3, c2.shape[-2:])
                            + self.reduce_conv_c2(c2))
        size = p2.shape[-2:]
        x = torch.cat([p2, resize_nearest(p3, size), resize_nearest(p4, size),
                       resize_nearest(p5, size)], dim=1)
        return self.conv(x)
