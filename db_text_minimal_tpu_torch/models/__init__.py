"""DBNet detector in PyTorch: resnet18 + FPN + DB head."""

from .dbnet import DBTextModel
from .fpn import FPN
from .head import HEADS, DBHead, FusedDBHead
from .resnet import BACKBONE_OUT_CHANNELS, BACKBONES, resnet18

__all__ = ["DBTextModel", "FPN", "HEADS", "DBHead", "FusedDBHead",
           "BACKBONE_OUT_CHANNELS", "BACKBONES", "resnet18"]
