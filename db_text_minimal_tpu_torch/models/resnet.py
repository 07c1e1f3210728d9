"""ResNet backbones returning c2..c5.

Counterpart of ``db_text_minimal_tpu/models/resnet.py``: ``BasicBlock``
(expansion 1) and ``Bottleneck`` (expansion 4, the stride on conv2), the
stem (7×7/2 conv with pad 3, BN, relu, 3×3/2 max pool), ``ResNet`` and the
seven constructors resnet18/34/50/101/152 and deformable_resnet18/50,
whose conv2 in layer2..layer4 is a ``DeformConv`` (``models/deform``).
Parameter names follow the reference's torchvision layout
(``layer1.0.conv1``, ``layer2.0.conv3``, ``layer2.0.downsample.0``; a
deformable block's ``conv2.weight`` and ``conv2.offset_conv``), which
``weights.state_dict_from_jax`` produces. The reference's unused
``smooth``/``avgpool``/``fc`` are left out. ``hidden_planes`` narrows a
BasicBlock's conv1 output (the width between its two convs, tied to
nothing else), as structured pruning leaves it (``models/prune``; JAX
resnet.py:45-56,115-146); Bottleneck blocks ignore it, as in JAX. Each
conv computes in its ``compute_dtype`` and each BN in float32 (see
``layers``), so in bfloat16 c2..c5 are float32, as in flax.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .deform import DeformConv
from .layers import Conv2d, batch_norm, max_pool_3x3_s2


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride,
                  padding=(kernel - 1) // 2, bias=False)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), batch_norm(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_dcn: bool = False,
                 hidden_planes: int | None = None):
        super().__init__()
        hidden = hidden_planes or planes
        self.conv1 = _conv(in_planes, hidden, 3, stride)
        self.bn1 = batch_norm(hidden)
        self.conv2 = (DeformConv(hidden, planes) if with_dcn
                      else _conv(hidden, planes, 3))
        self.bn2 = batch_norm(planes)
        self.downsample = (_downsample(in_planes, planes, stride)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_dcn: bool = False,
                 hidden_planes: int | None = None):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 1)
        self.bn1 = batch_norm(planes)
        self.conv2 = (DeformConv(planes, planes, stride) if with_dcn
                      else _conv(planes, planes, 3, stride))
        self.bn2 = batch_norm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = (_downsample(in_planes, planes * 4, stride)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet(nn.Module):
    """``hidden_planes``: one conv1 width per block in creation order
    (layer1.0, layer1.1, ..., layer4.N); 0 or None keeps the default.
    ``dcn`` makes conv2 of layer2..layer4 deformable (JAX resnet.py:136)."""

    def __init__(self, block, layers, dcn: bool = False, hidden_planes=None):
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
            seq = []
            for b in range(blocks):
                s = 2 if stage > 0 and b == 0 else 1
                out = planes * block.expansion
                seq.append(block(in_planes, planes, s,
                                 downsample=b == 0 and (s != 1
                                                        or in_planes != out),
                                 with_dcn=dcn and stage > 0,
                                 hidden_planes=hidden.pop(0) or None))
                in_planes = out
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))

    def forward(self, x):
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        c2 = self.layer1(x)
        c3 = self.layer2(c2)
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return c2, c3, c4, c5


def resnet18(hidden_planes=None) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), hidden_planes=hidden_planes)


def deformable_resnet18(hidden_planes=None) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), True, hidden_planes)


def resnet34(hidden_planes=None) -> ResNet:
    return ResNet(BasicBlock, (3, 4, 6, 3), hidden_planes=hidden_planes)


def resnet50(hidden_planes=None) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), hidden_planes=hidden_planes)


def deformable_resnet50(hidden_planes=None) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), True, hidden_planes)


def resnet101(hidden_planes=None) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), hidden_planes=hidden_planes)


def resnet152(hidden_planes=None) -> ResNet:
    return ResNet(Bottleneck, (3, 8, 36, 3), hidden_planes=hidden_planes)


_BASIC, _WIDE = (64, 128, 256, 512), (256, 512, 1024, 2048)
BACKBONE_OUT_CHANNELS = {
    "resnet18": _BASIC, "deformable_resnet18": _BASIC, "resnet34": _BASIC,
    "resnet50": _WIDE, "deformable_resnet50": _WIDE, "resnet101": _WIDE,
    "resnet152": _WIDE,
}
BACKBONES = {
    "resnet18": resnet18, "deformable_resnet18": deformable_resnet18,
    "resnet34": resnet34, "resnet50": resnet50,
    "deformable_resnet50": deformable_resnet50, "resnet101": resnet101,
    "resnet152": resnet152,
}
