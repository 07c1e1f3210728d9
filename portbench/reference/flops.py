"""Model FLOPs of a configuration, from its shapes.

The reference forward runs on the ``meta`` device with ``CountOps``, which
records every convolution's multiply-accumulates (MACs) from its input and
kernel shapes and computes nothing: a conv or deconv costs
(output pixels for a conv, input pixels for a deconv) · C_in · C_out · k²
MACs, a deformable conv that of a 3×3 conv at its output size (its offset
conv is counted as the conv it is). FLOPs are 2 · MACs. Norms, activations,
pooling, resizes and the sampling of the deformable conv are not counted.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import model as M


class CountOps(M.Ops):
    def __init__(self, bn_mode: str = "train"):
        super().__init__(bn_mode)
        self.macs = 0
        self.deform_shapes: list = []

    def conv(self, x, w, b=None, stride=1, pad=0):
        y = F.conv2d(x, w, b, stride, pad)
        self.macs += (y.shape[0] * y.shape[2] * y.shape[3] * w.shape[0]
                      * w.shape[1] * w.shape[2] * w.shape[3])
        return y

    def deconv(self, x, w, b):
        self.macs += (x.shape[0] * x.shape[2] * x.shape[3] * w.shape[0]
                      * w.shape[1] * w.shape[2] * w.shape[3])
        return F.conv_transpose2d(x, w, b, stride=2)

    def deform(self, x, offsets, w, stride):
        n, _, oh, ow = offsets.shape
        self.macs += n * oh * ow * w.shape[0] * w.shape[1] * 9
        self.deform_shapes.append((tuple(x.shape), stride))
        return torch.empty((n, w.shape[0], oh, ow), device=x.device)


def count(cfg: dict, batch: int, size: int, train: bool = False,
          prob_only: bool = False) -> CountOps:
    """The ``CountOps`` of one forward at ``batch`` × ``size``²: ``macs``
    and ``deform_shapes`` ((N, C, H, W) input, stride) in call order."""
    weights = {name: torch.empty(shape, device="meta")
               for name, shape, _ in M.param_spec(cfg)}
    ops = CountOps("eval" if not train else "train")
    x = torch.empty((batch, 3, size, size), device="meta")
    M.forward(weights, x, cfg, ops, train=train, prob_only=prob_only)
    return ops


def forward_flops(cfg: dict, batch: int, size: int,
                  prob_only: bool = False) -> int:
    return 2 * count(cfg, batch, size, prob_only=prob_only).macs


def train_step_flops(cfg: dict, batch: int, size: int) -> int:
    """A training step's model FLOPs: the forward's, three times (the
    forward, and the backward's two products of each conv)."""
    return 3 * 2 * count(cfg, batch, size, train=True).macs
