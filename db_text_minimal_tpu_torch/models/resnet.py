"""ResNet-18 backbone returning c2..c5.

Counterpart of ``db_text_minimal_tpu/models/resnet.py`` (``BasicBlock`` and
the stem: 7×7/2 conv with pad 3, BN, relu, 3×3/2 max pool). Parameter names
follow the reference's torchvision layout (``layer1.0.conv1``,
``layer2.0.downsample.0``), which ``weights.state_dict_from_jax`` produces.
The reference's unused ``smooth``/``avgpool``/``fc`` are left out.
``hidden_planes`` narrows each block's conv1 output (the width between its
two convs, tied to nothing else), as structured pruning leaves it
(``models/prune``; JAX resnet.py:45-56,115). Each
conv computes in its ``compute_dtype`` and each BN in float32 (see
``layers``), so in bfloat16 c2..c5 are float32, as in flax.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, batch_norm, max_pool_3x3_s2


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride,
                  padding=(kernel - 1) // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 hidden_planes: int | None = None):
        super().__init__()
        hidden = hidden_planes or planes
        self.conv1 = _conv(in_planes, hidden, 3, stride)
        self.bn1 = batch_norm(hidden)
        self.conv2 = _conv(hidden, planes, 3)
        self.bn2 = batch_norm(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(_conv(in_planes, planes, 1, stride),
                                            batch_norm(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet(nn.Module):
    """``hidden_planes``: one conv1 width per block in creation order
    (layer1.0, layer1.1, ..., layer4.1); 0 or None keeps the default."""

    def __init__(self, layers=(2, 2, 2, 2), hidden_planes=None):
        super().__init__()
        hidden = list(hidden_planes or [0] * sum(layers))
        if len(hidden) != sum(layers):
            raise ValueError(f"hidden_planes has {len(hidden)} entries for "
                             f"{sum(layers)} blocks")
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = batch_norm(64)
        in_planes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     layers)):
            stride = 1 if stage == 0 else 2
            seq = []
            for b in range(blocks):
                seq.append(BasicBlock(in_planes, planes,
                                      stride if b == 0 else 1,
                                      hidden.pop(0) or None))
                in_planes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))

    def forward(self, x):
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        c2 = self.layer1(x)
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return c2, c3, c4, c5


def resnet18(hidden_planes=None) -> ResNet:
    return ResNet((2, 2, 2, 2), hidden_planes)


BACKBONE_OUT_CHANNELS = {"resnet18": (64, 128, 256, 512)}
BACKBONES = {"resnet18": resnet18}
