"""Model loading and the inference forward shared by the entry points.

Counterpart of ``db_text_minimal_tpu/cli/common.py``: ``load_model``, and
``make_forward`` / ``build_inference_forward`` for the plain module forward
(the JAX package's ``infer_mode="flax"``). The BN-folded and int8 forwards
are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import DBTextModel
from ..models.head import fuse_variables
from ..train.checkpoints import load_params_any
from ..utils import resolve_device

NOT_PORTED = ("infer_mode {!r} (BN-folded / int8 forward) is not ported "
              "yet: ROADMAP item 13")


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


def make_forward(model: DBTextModel):
    """``forward(x)``: a float32 NHWC numpy batch -> the eval mode's NHWC
    prob and threshold maps, on the model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def forward(x: np.ndarray) -> torch.Tensor:
        return model(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                     .to(device))

    return forward


def build_inference_forward(model_path: str, backbone: str = "resnet18",
                            infer_mode: str = "flax", device="cuda"):
    """The CLIs' inference builder: (model, forward) for the plain module
    forward of a ``.pth`` (``infer_mode="flax"``, the JAX package's name for
    it). ``"folded"`` and ``"int8"`` raise: not ported yet."""
    if infer_mode != "flax":
        raise NotImplementedError(NOT_PORTED.format(infer_mode))
    model = load_model(model_path, device=device, backbone=backbone)
    return model, make_forward(model)
