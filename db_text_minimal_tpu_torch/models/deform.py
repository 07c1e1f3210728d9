"""Gather-based deformable convolution (DCNv1) in plain PyTorch.

Counterpart of ``db_text_minimal_tpu/models/deform.py``: a 3×3 conv whose 9
sampling locations are shifted per output pixel by learned offsets (18
channels = 9 taps × (dy, dx), row-major over the taps), out-of-image reads
zero, padding 1 and an optional stride. The deformable ResNets' conv2
(``models/resnet``) is one.

Computed as the JAX module formulates it (deform.py:24-51,62-97), so that
outputs and all three gradients agree with it:

- each tap samples bilinearly by ``floor`` and four gathers, each corner
  with its own validity mask and its index clamped into the image. At an
  integer coordinate (every sample at init, where the offsets are zero)
  the weight of the lower corner is 1, and the gradient with respect to
  the offset is the difference towards the next row or column, as in
  JAX. ``F.grid_sample`` is not used: its unnormalising arithmetic moves
  some integer coordinates below themselves, where the one-sided gradient
  takes the other side;
- a gather reads rows of the (N·H·W, C) view of the NHWC-contiguous input
  through one flat index per output pixel, not ``torch.gather`` with an
  index expanded over C;
- the offset conv and the sampling run in float32 in every compute dtype;
  only the per-tap product, and the sum over the taps, run in
  ``compute_dtype`` (flax's ``dtype``; ``DBTextModel`` sets it).

The kernel is ``weight`` of shape (F, C, 3, 3), the state_dict layout of a
conv; ``offset_conv`` is a 3×3 conv to 18 channels with a bias, at the
block's stride, zero at init (``layers.init_weights``).
"""

from __future__ import annotations

import torch
from torch import nn


def _bilinear_sample(flat: torch.Tensor, n: int, h: int, w: int,
                     y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample the NHWC image whose (N·H·W, C) rows are ``flat`` at the float
    coordinates (y, x), each (N, OH, OW); returns (N, OH, OW, C). Reads
    outside the image are zero."""
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0)[..., None]
    wx = (x - x0)[..., None]
    image = (torch.arange(n, device=flat.device) * (h * w))[:, None, None]

    def gather(yy, xx):
        valid = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
        yc = yy.clamp(0, h - 1).long()
        xc = xx.clamp(0, w - 1).long()
        vals = flat[(image + yc * w + xc).reshape(-1)]
        return torch.where(valid, vals.reshape(*yy.shape, -1), 0.0)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


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
        n, c, h, w = x.shape
        s = self.stride
        oh, ow = (h + s - 1) // s, (w + s - 1) // s
        xf = x.float()
        offsets = self.offset_conv(xf)               # (N, 18, OH, OW)
        flat = xf.permute(0, 2, 3, 1).reshape(-1, c)
        base_y = (torch.arange(oh, device=x.device, dtype=torch.float32)
                  * s)[None, :, None]
        base_x = (torch.arange(ow, device=x.device, dtype=torch.float32)
                  * s)[None, None, :]
        dt = self.compute_dtype
        out = torch.zeros(n * oh * ow, self.weight.shape[0], dtype=dt,
                          device=x.device)
        for ky in range(3):
            for kx in range(3):
                tap = ky * 3 + kx
                sy = base_y + (ky - 1) + offsets[:, 2 * tap]
                sx = base_x + (kx - 1) + offsets[:, 2 * tap + 1]
                sampled = _bilinear_sample(flat, n, h, w, sy, sx)
                out = out + sampled.reshape(-1, c).to(dt) @ \
                    self.weight[:, :, ky, kx].t().to(dt)
        return out.reshape(n, oh, ow, -1).permute(0, 3, 1, 2)
