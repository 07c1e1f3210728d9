"""DB segmentation head.

Counterpart of ``db_text_minimal_tpu/models/head.py``. Each ``DBHead``
branch is conv3×3(C→C/4) + BN + relu → deconv2×2/2 + BN + relu →
deconv2×2/2 → sigmoid, kept as an ``nn.Sequential`` whose indices 0/1/3/4/6
are the reference's key names. The binarize conv1 has a bias, the thresh
conv1 does not. ``width`` pins the branches' width (default C/4), so that a
pruned neck output does not shrink the head with it (JAX head.py:36-40). ``FusedDBHead`` runs both branches' first convs as one
conv and is weight-compatible through ``fuse_db_head_params``; it is an
inference form and refuses train mode, as the JAX version asserts.

In train mode ``DBHead`` returns (P, T, B̂) with B̂ = σ(k(P − T)) through
kernel K2 (``ops.db_step.db_step``, head.py:76-84).

In a bfloat16 model (``layers``) the convs and deconvs compute in bfloat16
and the BNs in float32; the last deconv's bfloat16 output goes to a float32
sigmoid (JAX head.py:57,121), so P and T, and K2's inputs and output, are
float32 in every compute dtype: ``ops.db_step`` and its Triton kernels see
the maps they saw in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.db_step import db_step
from .layers import Conv2d, ConvTranspose2d, Sigmoid32, batch_norm


def _branch(channels: int, width: int, first_bias: bool) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(channels, width, 3, padding=1, bias=first_bias),
        batch_norm(width), nn.ReLU(inplace=True),
        ConvTranspose2d(width, width, 2, stride=2),
        batch_norm(width), nn.ReLU(inplace=True),
        ConvTranspose2d(width, 1, 2, stride=2), Sigmoid32())


class DBHead(nn.Module):
    """NCHW in; (N, 2, H, W) = (P, T) out in eval mode, (N, 3, H, W) =
    (P, T, B̂) in train mode."""

    k = 50.0   # the step's steepness, the reference's and the JAX default

    def __init__(self, in_channels: int = 256, width: int | None = None):
        super().__init__()
        width = width or in_channels // 4
        self.binarize = _branch(in_channels, width, True)
        self.thresh = _branch(in_channels, width, False)

    def forward(self, x):
        shrink, threshold = self.binarize(x), self.thresh(x)
        if self.training:
            return torch.cat([shrink, threshold,
                              db_step(shrink, threshold, self.k)], dim=1)
        return torch.cat([shrink, threshold], dim=1)


class FusedDBHead(nn.Module):
    """Inference form of ``DBHead``: the two branches' 3×3 convs (C→C/4
    each) run as one C→C/2 conv, then each half goes through its own
    tail. Eval mode only."""

    def __init__(self, in_channels: int = 256, width: int | None = None):
        super().__init__()
        width = width or in_channels // 4
        self.conv1 = Conv2d(in_channels, 2 * width, 3, padding=1)
        self.bn1 = batch_norm(2 * width)
        for name in ("binarize", "thresh"):
            setattr(self, f"{name}_deconv1",
                    ConvTranspose2d(width, width, 2, stride=2))
            setattr(self, f"{name}_bn2", batch_norm(width))
            setattr(self, f"{name}_deconv2",
                    ConvTranspose2d(width, 1, 2, stride=2))

    def _tail(self, z, name):
        z = getattr(self, f"{name}_deconv1")(z)
        z = F.relu(getattr(self, f"{name}_bn2")(z))
        return torch.sigmoid(getattr(self, f"{name}_deconv2")(z).float())

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "FusedDBHead is an inference form; train a DBHead")
        h = F.relu(self.bn1(self.conv1(x)))
        half = h.shape[1] // 2
        return torch.cat([self._tail(h[:, :half], "binarize"),
                          self._tail(h[:, half:], "thresh")], dim=1)


_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def fuse_db_head_params(head: dict) -> dict:
    """``DBHead`` state_dict (keys relative to the head, e.g.
    ``binarize.0.weight``) -> ``FusedDBHead`` state_dict: conv1 weights and
    bn1 concatenated along output channels, the thresh branch's missing
    conv1 bias as zeros, the tails passed through."""
    b_bias = head["binarize.0.bias"]
    fused = {
        "conv1.weight": torch.cat([head["binarize.0.weight"],
                                   head["thresh.0.weight"]], 0),
        "conv1.bias": torch.cat([b_bias, torch.zeros_like(b_bias)]),
    }
    for key in _BN_KEYS:
        fused[f"bn1.{key}"] = torch.cat([head[f"binarize.1.{key}"],
                                         head[f"thresh.1.{key}"]])
    fused["bn1.num_batches_tracked"] = head["binarize.1.num_batches_tracked"]
    for branch in ("binarize", "thresh"):
        for idx, layer in (("3", "deconv1"), ("4", "bn2"), ("6", "deconv2")):
            prefix = f"{branch}.{idx}."
            for key, value in head.items():
                if key.startswith(prefix):
                    fused[f"{branch}_{layer}.{key[len(prefix):]}"] = value
    return fused


def fuse_variables(state_dict: dict) -> dict:
    """Full ``DBTextModel`` state_dict with a ``DBHead`` -> the
    ``FusedDBHead`` layout; backbone and neck keys pass through."""
    prefix = "segmentation_head."
    head = {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}
    out = {k: v for k, v in state_dict.items() if not k.startswith(prefix)}
    out.update({prefix + k: v for k, v in fuse_db_head_params(head).items()})
    return out


class ConvHead(nn.Module):
    """A 1×1 conv with a bias, then a float32 sigmoid (JAX
    head.py:177-188). ``DBTextModel`` cannot build it: JAX's
    ``DBTextModel`` passes it no ``out_channels``, so only the head itself
    is held to JAX's."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        return torch.sigmoid(self.conv(x).float())


HEADS = {"DBHead": DBHead, "FusedDBHead": FusedDBHead, "ConvHead": ConvHead}
