"""Model loading and the inference forwards shared by the entry points.

Counterpart of ``db_text_minimal_tpu/cli/common.py``: ``load_model``,
``make_forward`` for the plain module forward (the JAX package's
``infer_mode="flax"``), ``make_folded_forward`` for the BN-folded and int8
forwards (``models/quant_infer``) and ``build_inference_forward``, which
chooses among the three, and ``add_inference_args``, the argparse set of
``cli/test``. A pruned checkpoint's ``.widths.json`` sidecar
(``models/prune``) is applied wherever a checkpoint is loaded: the plain
model is built at its widths, and the folded trees take their shapes from
its weights.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models import DBTextModel
from ..models.head import fuse_variables
from ..models.prune import load_widths, widths_to_model_kwargs
from ..models.quant_infer import (calibrate_activation_scales,
                                  prepare_quant_params, quant_dbnet_forward,
                                  tree_to)
from ..train.checkpoints import load_params_any
from ..utils import resolve_device, str_to_bool

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
    """The state_dict of a ``.pth`` or a checkpoint; ``fuse_head=True``
    rewrites a ``DBHead`` checkpoint into the ``FusedDBHead`` layout. A
    pruned checkpoint's weights come at its widths."""
    if not os.path.exists(model_path):
        raise FileNotFoundError(model_path)
    state_dict = load_params_any(model_path)
    if fuse_head and "segmentation_head.binarize.0.weight" in state_dict:
        state_dict = fuse_variables(state_dict)
    return state_dict


def neck_of(state_dict: dict) -> str:
    """The neck whose keys a detector state_dict holds: ``FPEM_FFM`` (its
    ``segmentation_body.fpem_0`` ...) or ``FPN``."""
    fpem = any(k.startswith("segmentation_body.fpem_") for k in state_dict)
    return "FPEM_FFM" if fpem else "FPN"


def load_model(model_path: str, device="cuda", backbone: str = "resnet18",
               neck: str | None = None, head: str = "DBHead",
               fuse_head: bool = False,
               dtype: torch.dtype | None = None) -> DBTextModel:
    """Build the detector on ``device``, load a ``.pth`` into it and return
    it in eval mode. ``backbone`` is any of ``models.BACKBONES`` and
    ``neck`` either of ``models.NECKS``; by default the neck is the one
    whose keys the checkpoint holds (``neck_of``), so the entry points
    that take only ``--backbone`` load every family (JAX ``common.py``
    defaults to ``"FPN"``). ``fuse_head=True`` rewrites a ``DBHead`` checkpoint
    into the weight-equivalent ``FusedDBHead`` inference layout. The default
    device is CUDA; on a machine without a GPU, ``device="cpu"`` must be
    passed.

    ``dtype`` is the compute dtype (``DBTextModel.compute_dtype``); by
    default bfloat16 on CUDA and float32 on the CPU (``default_dtype``).
    ``torch.float32`` is the parity configuration: convolutions and matmuls
    in full float32 (TF32 off for the process). A pruned checkpoint's
    widths sidecar gives the narrow model."""
    device = resolve_device(device)
    _fp32_convolutions()
    state_dict = load_state_dict(model_path, fuse_head and head == "DBHead")
    if fuse_head and head == "DBHead":
        head = "FusedDBHead"
    model = DBTextModel(backbone_name=backbone,
                        neck_name=neck or neck_of(state_dict),
                        head_name=head,
                        compute_dtype=dtype or default_dtype(device),
                        **widths_to_model_kwargs(load_widths(model_path)))
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
                        stem_s2d: bool = False, prob_only: bool = False,
                        calibration=None, skip: tuple = (), device="cuda"):
    """The folded inference forward of the flagship resnet18 + FPN model
    (``models/quant_infer``): BN folded offline; with ``quantize`` the wide
    convs int8 but those under a name in ``skip`` (the default ``()``
    quantizes the fused head's conv1 too), at static scales calibrated on
    the batches of ``calibration`` where given, else dynamic ones;
    optionally the space-to-depth stem (``stem_s2d``, off by default as in
    the JAX package) and the prob-only head. ``state_dict`` is in the
    ``FusedDBHead`` layout. Returns ``forward(x, prob_only=prob_only)``: a
    float32 NHWC batch (numpy or tensor) -> NHWC maps on ``device``; its
    folded tree is ``forward.qvars``."""
    device = resolve_device(device)
    _fp32_convolutions()
    qv = tree_to(prepare_quant_params(
        state_dict, skip=skip,
        min_out_channels=128 if quantize else 10**9,
        stem_s2d=stem_s2d), device)
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
    ``infer_mode="flax"`` is the plain module of any family (both maps;
    bfloat16 on CUDA, float32 on the CPU, as ``load_model``, the neck
    from the checkpoint); ``"folded"`` and
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
    state_dict = load_state_dict(model_path, fuse_head=True)
    if backbone != "resnet18" or neck_of(state_dict) != "FPN":
        raise ValueError("--infer_mode folded/int8 supports the flagship "
                         "resnet18 + FPN")
    forward = make_folded_forward(state_dict,
                                  quantize=infer_mode == "int8",
                                  prob_only=prob_only, device=device)
    return forward.qvars, forward


def add_inference_args(parser: argparse.ArgumentParser) -> None:
    """The argparse set of ``cli/test`` (the reference's ``src/test.py``
    21-42). ``--device`` picks the device, CUDA by default."""
    parser.add_argument("--image_path", type=str, default="./assets/foo.jpg")
    parser.add_argument("--model_path", type=str,
                        default="./models/best_cp.ckpt")
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--save_dir", type=str, default="./assets")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--prob_thred", type=float, default=0.5)
    parser.add_argument("--heatmap", type=str_to_bool, default=False)
    parser.add_argument("--thresh", type=float, default=0.5)
    parser.add_argument("--box_thresh", type=float, default=0.7)
    parser.add_argument("--unclip_ratio", type=float, default=1.5)
    parser.add_argument("--is_output_polygon", type=str_to_bool,
                        default=False)
    parser.add_argument("--alpha", type=float, default=0.6)
    parser.add_argument("--infer_mode", type=str, default="flax",
                        choices=INFER_MODES,
                        help="flax = the plain model; folded = the "
                             "BN-folded prob-only forward; int8 = the same "
                             "with the wide convs int8")
