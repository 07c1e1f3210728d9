"""DBNet detector in PyTorch: the ResNet backbones (deformable ones
included), the FPN and FPEM_FFM necks and the DB heads."""

from .dbnet import DBTextModel
from .deform import DeformConv
from .fpn import FPEM_FFM, FPN, NECKS
from .head import HEADS, ConvHead, DBHead, FusedDBHead
from .resnet import BACKBONE_OUT_CHANNELS, BACKBONES, resnet18

__all__ = ["DBTextModel", "DeformConv", "FPN", "FPEM_FFM", "NECKS",
           "HEADS", "ConvHead", "DBHead", "FusedDBHead",
           "BACKBONE_OUT_CHANNELS", "BACKBONES", "resnet18"]
