"""Model loading and the inference forwards shared by the entry points.

Counterpart of ``db_text_minimal_tpu/cli/common.py``: ``load_model``,
``make_forward`` for the plain module forward (the JAX package's
``infer_mode="flax"``), ``make_folded_forward`` for the BN-folded and int8
forwards (``models/quant_infer``) and ``build_inference_forward``, which
chooses among the three.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import DBTextModel
from ..models.head import fuse_variables
from ..models.quant_infer import (calibrate_activation_scales,
                                  prepare_quant_params, quant_dbnet_forward,
                                  tree_to)
from ..train.checkpoints import load_params_any
from ..utils import resolve_device

INFER_MODES = ("flax", "folded", "int8")


def default_dtype(device: torch.device) -> torch.dtype:
    """The plain model's compute dtype when none is asked for: bfloat16 on
    CUDA, float32 on the CPU (JAX ``common.py:30-32``, with CUDA in its
    accelerator's place)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _fp32_convolutions() -> None:
    """cuDNN runs float32 convolutions in TF32 unless told otherwise, which
    keeps only ~3 decimal digits; the entry points turn it off."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def load_state_dict(model_path: str, fuse_head: bool = False) -> dict:
    """The state_dict of a ``.pth``; ``fuse_head=True`` rewrites a
    ``DBHead`` checkpoint into the ``FusedDBHead`` layout."""
    if not os.path.exists(model_path):
        raise FileNotFoundError(model_path)
    state_dict = load_params_any(model_path)
    if fuse_head and "segmentation_head.binarize.0.weight" in state_dict:
        state_dict = fuse_variables(state_dict)
    return state_dict


def load_model(model_path: str, device="cuda", backbone: str = "resnet18",
               head: str = "DBHead", fuse_head: bool = False,
               dtype: torch.dtype | None = None) -> DBTextModel:
    """Build the detector on ``device``, load a ``.pth`` into it and return
    it in eval mode. ``fuse_head=True`` rewrites a ``DBHead`` checkpoint
    into the weight-equivalent ``FusedDBHead`` inference layout. The default
    device is CUDA; on a machine without a GPU, ``device="cpu"`` must be
    passed.

    ``dtype`` is the compute dtype (``DBTextModel.compute_dtype``); by
    default bfloat16 on CUDA and float32 on the CPU (``default_dtype``).
    ``torch.float32`` is the parity configuration: convolutions and matmuls
    in full float32 (TF32 off for the process)."""
    device = resolve_device(device)
    _fp32_convolutions()
    state_dict = load_state_dict(model_path, fuse_head and head == "DBHead")
    if fuse_head and head == "DBHead":
        head = "FusedDBHead"
    model = DBTextModel(backbone_name=backbone, head_name=head,
                        compute_dtype=dtype or default_dtype(device))
    model.load_state_dict(state_dict, strict=True)
    return model.to(device).eval()


def make_forward(model: DBTextModel):
    """``forward(x)``: a float32 NHWC numpy batch -> the eval mode's NHWC
    prob and threshold maps (float32 in every compute dtype), on the
    model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def forward(x: np.ndarray) -> torch.Tensor:
        return model(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                     .to(device))

    return forward


def make_folded_forward(state_dict: dict, quantize: bool = False,
                        prob_only: bool = False, calibration=None,
                        skip: tuple = (), device="cuda"):
    """The folded inference forward of the flagship resnet18 + FPN model
    (``models/quant_infer``): BN folded offline; with ``quantize`` the wide
    convs int8 but those under a name in ``skip`` (the default ``()``
    quantizes the fused head's conv1 too), at static scales calibrated on
    the batches of ``calibration`` where given, else dynamic ones;
    optionally the prob-only head. ``state_dict`` is in the ``FusedDBHead``
    layout. Returns ``forward(x, prob_only=prob_only)``: a float32 NHWC
    batch (numpy or tensor) -> NHWC maps on ``device``; its folded tree is
    ``forward.qvars``."""
    device = resolve_device(device)
    _fp32_convolutions()
    qv = tree_to(prepare_quant_params(
        state_dict, skip=skip,
        min_out_channels=128 if quantize else 10**9), device)
    if quantize and calibration is not None:
        qv = calibrate_activation_scales(qv, calibration)

    @torch.inference_mode()
    def forward(x, prob_only: bool = prob_only) -> torch.Tensor:
        x = torch.as_tensor(np.ascontiguousarray(x, np.float32)
                            if isinstance(x, np.ndarray) else x,
                            dtype=torch.float32).to(device)
        return quant_dbnet_forward(qv, x, prob_only=prob_only)

    forward.qvars = qv
    return forward


def build_inference_forward(model_path: str, backbone: str = "resnet18",
                            infer_mode: str = "flax", prob_only: bool = True,
                            device="cuda"):
    """What the CLIs infer with: (model or folded tree, forward), where
    ``forward`` maps a float32 NHWC numpy batch to NHWC maps on ``device``.
    ``infer_mode="flax"`` is the plain module (both maps; bfloat16 on CUDA,
    float32 on the CPU, as ``load_model``); ``"folded"`` and
    ``"int8"`` the BN-folded forward, int8 with dynamic scales (flagship
    resnet18 + FPN only), which with ``prob_only`` return (N, H, W, 1), all
    the detection postprocess reads."""
    if infer_mode not in INFER_MODES:
        raise ValueError(f"infer_mode {infer_mode!r} is not one of "
                         f"{INFER_MODES}")
    device = resolve_device(device)
    if infer_mode == "flax":
        model = load_model(model_path, device=device, backbone=backbone)
        return model, make_forward(model)
    if backbone != "resnet18":
        raise ValueError("--infer_mode folded/int8 supports the flagship "
                         "resnet18 + FPN")
    forward = make_folded_forward(load_state_dict(model_path, fuse_head=True),
                                  quantize=infer_mode == "int8",
                                  prob_only=prob_only, device=device)
    return forward.qvars, forward
