"""Top-level DBNet detector: backbone → neck → head → full-res output.

Counterpart of ``db_text_minimal_tpu/models/dbnet.py::DBTextModel``. The
public layout is the JAX package's: ``forward`` takes NHWC float images and
returns NHWC (N, H, W, 2) = (prob, thresh) in eval mode and (N, H, W, 3) =
(prob, thresh, B̂) in train mode (dbnet.py:44-72); the align-corners resize
after the head is a no-op at 640². ``x.permute(0, 3, 1, 2)`` of a
contiguous NHWC tensor is already a channels-last NCHW tensor, so the
layout change costs no copy.
"""

from __future__ import annotations

import torch
from torch import nn

from .fpn import FPN
from .head import HEADS
from .layers import init_weights, resize_bilinear_align_corners
from .resnet import BACKBONE_OUT_CHANNELS, BACKBONES


class DBTextModel(nn.Module):
    def __init__(self, backbone_name: str = "resnet18",
                 head_name: str = "DBHead", inner_channels: int = 256):
        super().__init__()
        self.backbone = BACKBONES[backbone_name]()
        self.segmentation_body = FPN(BACKBONE_OUT_CHANNELS[backbone_name],
                                     inner_channels)
        self.segmentation_head = HEADS[head_name](inner_channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded random weights (the reference's init: Kaiming-normal
        convs, BN γ=1, β=0, head BN β=1e-4)."""
        init_weights(self.backbone, generator)
        init_weights(self.segmentation_body, generator)
        init_weights(self.segmentation_head, generator, head_bn_bias=1e-4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        y = x.permute(0, 3, 1, 2)
        y = self.segmentation_head(self.segmentation_body(self.backbone(y)))
        y = resize_bilinear_align_corners(y.float(), (h, w))
        return y.permute(0, 2, 3, 1)
