"""Model loading shared by the entry points.

Counterpart of ``db_text_minimal_tpu/cli/common.py::load_model``.
"""

from __future__ import annotations

import os

import torch

from ..models import DBTextModel
from ..models.head import fuse_variables
from ..train.checkpoints import load_params_any
from ..utils import resolve_device


def load_model(model_path: str, device="cuda", backbone: str = "resnet18",
               head: str = "DBHead", fuse_head: bool = False) -> DBTextModel:
    """Build the detector on ``device``, load a ``.pth`` into it and return
    it in eval mode. ``fuse_head=True`` rewrites a ``DBHead`` checkpoint
    into the weight-equivalent ``FusedDBHead`` inference layout. The default
    device is CUDA; on a machine without a GPU, ``device="cpu"`` must be
    passed.

    The model runs in the fp32 parity configuration: convolutions and
    matmuls in full float32. cuDNN runs float32 convolutions in TF32 unless
    told otherwise, which keeps only ~3 decimal digits, so this entry point
    turns TF32 off for the process."""
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not os.path.exists(model_path):
        raise FileNotFoundError(model_path)
    state_dict = load_params_any(model_path)
    if fuse_head and head == "DBHead":
        state_dict = fuse_variables(state_dict)
        head = "FusedDBHead"
    model = DBTextModel(backbone_name=backbone, head_name=head)
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()
