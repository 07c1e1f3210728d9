"""The necks: FPN and FPEM_FFM.

Counterpart of ``db_text_minimal_tpu/models/fpn.py``. ``FPN``: 1×1 reduce
convs to inner/4 channels, nearest-upsample top-down adds, 3×3 smooth convs,
upsample-all-and-concat at p2 scale, then a final 3×3 conv + BN + relu kept
as the ``nn.Sequential`` ``conv`` (keys ``conv.0``/``conv.1``).
``inner_quarter`` and ``out_features`` override the tied reduce/smooth
width (default inner/4) and the output width (default inner), as
structured pruning leaves them (``models/prune``; JAX fpn.py:24-31). Convs
compute in their ``compute_dtype``, BNs in float32 (``layers``), so every
add and concat here is float32, as in flax.

``FPEM_FFM`` (the PANnet neck, JAX fpn.py:72-154): 1×1 reduce convs to
128 channels, two ``FPEM``s (an up phase of nearest-resize adds, then a
down phase that resizes the coarser map up to the finer one, adds and
applies a stride-2 separable conv), the FFM sum of the FPEMs' outputs, and
the four scales concatenated at c2's: 4 · 128 = 512 channels. A
``SeparableConv2d`` is a depthwise 3×3 conv and a pointwise 1×1 conv, both
with a bias (flax's default), then BN and relu.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, ConvBnRelu, batch_norm, resize_nearest


class FPN(nn.Module):
    def __init__(self, in_channels=(64, 128, 256, 512),
                 inner_channels: int = 256, inner_quarter: int | None = None,
                 out_features: int | None = None):
        super().__init__()
        inner = inner_quarter or inner_channels // 4
        out = out_features or inner_channels
        c2, c3, c4, c5 = in_channels
        self.reduce_conv_c2 = ConvBnRelu(c2, inner, 1)
        self.reduce_conv_c3 = ConvBnRelu(c3, inner, 1)
        self.reduce_conv_c4 = ConvBnRelu(c4, inner, 1)
        self.reduce_conv_c5 = ConvBnRelu(c5, inner, 1)
        self.smooth_p4 = ConvBnRelu(inner, inner, 3, padding=1)
        self.smooth_p3 = ConvBnRelu(inner, inner, 3, padding=1)
        self.smooth_p2 = ConvBnRelu(inner, inner, 3, padding=1)
        self.conv = nn.Sequential(
            Conv2d(inner * 4, out, 3, padding=1),
            batch_norm(out), nn.ReLU(inplace=True))
        self.out_channels = out

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


class SeparableConv2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 stride: int = 1):
        super().__init__()
        self.depthwise_conv = Conv2d(in_channels, in_channels, 3,
                                     stride=stride, padding=1,
                                     groups=in_channels)
        self.pointwise_conv = Conv2d(in_channels, out_channels, 1)
        self.bn = batch_norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.pointwise_conv(self.depthwise_conv(x))))


def _up_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return resize_nearest(x, y.shape[-2:]) + y


class FPEM(nn.Module):
    def __init__(self, channels: int = 128):
        super().__init__()
        for i in (1, 2, 3):
            setattr(self, f"up_add{i}", SeparableConv2d(channels, channels))
        for i in (1, 2, 3):
            setattr(self, f"down_add{i}",
                    SeparableConv2d(channels, channels, 2))

    def forward(self, c2, c3, c4, c5):
        c4 = self.up_add1(_up_add(c5, c4))
        c3 = self.up_add2(_up_add(c4, c3))
        c2 = self.up_add3(_up_add(c3, c2))
        c3 = self.down_add1(_up_add(c3, c2))
        c4 = self.down_add2(_up_add(c4, c3))
        c5 = self.down_add3(_up_add(c5, c4))
        return c2, c3, c4, c5


class FPEM_FFM(nn.Module):
    def __init__(self, in_channels=(64, 128, 256, 512),
                 inner_channels: int = 128, fpem_repeat: int = 2):
        super().__init__()
        for i, c in zip((2, 3, 4, 5), in_channels):
            setattr(self, f"reduce_conv_c{i}",
                    ConvBnRelu(c, inner_channels, 1))
        for i in range(fpem_repeat):
            setattr(self, f"fpem_{i}", FPEM(inner_channels))
        self.fpem_repeat = fpem_repeat
        self.out_channels = inner_channels * 4

    def forward(self, feats):
        c = [getattr(self, f"reduce_conv_c{i}")(f)
             for i, f in zip((2, 3, 4, 5), feats)]
        ffm = None
        for i in range(self.fpem_repeat):
            c = getattr(self, f"fpem_{i}")(*c)
            ffm = list(c) if ffm is None else [a + b for a, b in zip(ffm, c)]
        size = ffm[0].shape[-2:]
        return torch.cat([ffm[0]] + [resize_nearest(f, size)
                                     for f in ffm[1:]], dim=1)


NECKS = {"FPN": FPN, "FPEM_FFM": FPEM_FFM}
