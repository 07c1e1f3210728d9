"""Ahead-of-time export of the detector for serving.

Port of ``db_text_minimal_tpu/serve/export.py``: the eval-mode forward is
captured by ``torch.export`` into one ``.pt2`` archive that holds the graph
and the weights, so serving needs neither the model's Python code nor a
checkpoint. As in the JAX export, the graph has a symbolic batch (one
archive serves any micro-batch size), takes uint8 images and subtracts the
Caffe means inside the graph, and serves one of three forwards:

- ``"flax"``: the plain module as given (its compute dtype, its head);
- ``"folded"``: the BN-folded forward (``models/quant_infer``);
- ``"int8"``: that with the wide convs int8 at dynamic scales, each a
  node of the graph (the custom op ``dbtext::int8_conv``, the convolution
  with P1's epilogue).

The folded and int8 trees live in the archive as buffers. ``prob_only``
exports the (N, H, W, 1) prob-map graph, all the detection postprocess
reads. A ``<out>.meta.json`` sidecar records the input contract under the
JAX keys (``uint8_input``, ``symbolic_batch``, ``input_shape``,
``infer_mode``, ``prob_only``), with the compute dtype, the device and the
torch version beside them, and a pruned model's widths.

An archive is tied to the torch version that wrote it and to the device
type it was exported on (the graph holds device constants):
``load_exported`` refuses another device type. The ``.pt2`` files are
made at run time and never committed.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

from ..cli.common import INFER_MODES, _fp32_convolutions
from ..models.head import fuse_variables
from ..models.quant_infer import (_compute_dtype, prepare_quant_params,
                                  quant_dbnet_forward, tree_to)
from ..utils import CAFFE_MEAN, resolve_device

# the symbolic batch's range. torch.export specializes sizes 0 and 1: on
# the card, torch 2.11 guards the traced batch at >= 2 (and at <= 65535, a
# grid limit), so the graph takes 2 to MAX_BATCH images and ``infer`` runs
# a batch of 1 as its image twice
MIN_BATCH, MAX_BATCH = 2, 1024


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, name + "__"))
        else:
            out[name] = value
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split("__")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


class _Forward(nn.Module):
    """What is exported: uint8 (or float) NHWC images -> NHWC maps. Holds
    the plain model as a submodule, or the folded tree as buffers."""

    def __init__(self, model: nn.Module | None, qvars: dict | None,
                 uint8_input: bool, prob_only: bool,
                 compute_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.model = model
        self.names = []
        for name, value in _flatten(qvars or {}).items():
            self.register_buffer(name, value)
            self.names.append(name)
        self.register_buffer("mean", torch.tensor(CAFFE_MEAN,
                                                  dtype=torch.float32,
                                                  device=device))
        self.uint8_input = uint8_input
        self.prob_only = prob_only
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.uint8_input:
            x = x.float() - self.mean
        if self.model is not None:
            y = self.model(x)
            return y[..., :1] if self.prob_only else y
        tree = _unflatten({n: getattr(self, n) for n in self.names})
        return quant_dbnet_forward(tree, x, prob_only=self.prob_only,
                                   compute_dtype=self.compute_dtype)


def _fused_state_dict(model_or_state_dict) -> dict:
    sd = (model_or_state_dict.state_dict()
          if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    if "segmentation_head.binarize.0.weight" in sd:
        sd = fuse_variables(sd)
    return sd


def export_model(model_or_state_dict, out_path: str,
                 input_shape=(None, 640, 640, 3), uint8_input: bool = True,
                 infer_mode: str = "flax", prob_only: bool = False,
                 device="cuda", widths: dict | None = None) -> str:
    """Export the eval-mode forward to ``out_path`` (``.pt2``) and write
    ``<out_path>.meta.json``; returns ``out_path``.

    ``input_shape[0] = None`` gives a symbolic batch (``Dim("b",
    min=MIN_BATCH, max=MAX_BATCH)``, traced at batch 2; ``load_exported``
    serves a batch of 1 too). With ``uint8_input`` the graph takes uint8 images
    and subtracts the Caffe means itself. ``infer_mode="flax"`` exports the
    given ``DBTextModel`` as it is (moved to ``device``); ``"folded"`` and
    ``"int8"`` fold a model's or a state_dict's weights (either head
    layout) and, for int8, quantize the wide convs, the fused head's conv1
    included, at dynamic scales (``skip=()``, as the JAX export). A pruned
    model's ``widths`` (its sidecar) go into the meta. The default device
    is CUDA; on a machine without a GPU, ``device="cpu"`` must be
    passed."""
    if infer_mode not in INFER_MODES:
        raise ValueError(f"unknown infer_mode: {infer_mode!r}")
    device = resolve_device(device)
    _fp32_convolutions()
    if infer_mode == "flax":
        if not isinstance(model_or_state_dict, nn.Module):
            raise TypeError("infer_mode 'flax' exports a DBTextModel")
        model = model_or_state_dict.to(device).eval()
        wrapper = _Forward(model, None, uint8_input, prob_only,
                           model.compute_dtype, device)
        compute_dtype = model.compute_dtype
    else:
        qv = tree_to(prepare_quant_params(
            _fused_state_dict(model_or_state_dict), skip=(),
            min_out_channels=128 if infer_mode == "int8" else 10**9),
            device)
        compute_dtype = _compute_dtype(device)
        wrapper = _Forward(None, qv, uint8_input, prob_only, compute_dtype,
                           device)
    wrapper.eval()

    symbolic = input_shape[0] is None
    batch = 2 if symbolic else int(input_shape[0])
    example = torch.zeros((batch,) + tuple(input_shape[1:]),
                          dtype=torch.uint8 if uint8_input else torch.float32,
                          device=device)
    dynamic = ({"x": {0: torch.export.Dim("b", min=MIN_BATCH,
                                          max=MAX_BATCH)}}
               if symbolic else None)
    with torch.no_grad():
        program = torch.export.export(wrapper, (example,),
                                      dynamic_shapes=dynamic)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.export.save(program, out_path)
    meta = {"uint8_input": uint8_input, "symbolic_batch": symbolic,
            "input_shape": list(input_shape), "infer_mode": infer_mode,
            "prob_only": prob_only,
            "compute_dtype": str(compute_dtype).removeprefix("torch."),
            "device": device.type, "torch": torch.__version__}
    if widths:
        meta["widths"] = widths
    with open(out_path + ".meta.json", "w") as f:
        json.dump(meta, f)
    return out_path


def load_exported(path: str, device="cuda"):
    """Load an export; returns ``infer(x)``: a uint8 (float where the
    export says so) NHWC batch, numpy or tensor, -> the NHWC maps on
    ``device``, with the sidecar as ``infer.meta``. A symbolic-batch
    archive serves a batch of 1 as its image twice (MIN_BATCH). The default device is
    CUDA; on a machine without a GPU, ``device="cpu"`` must be passed."""
    from ..ops import deform, int8  # noqa: F401 (registers the custom ops)

    device = resolve_device(device)
    _fp32_convolutions()
    meta = {"uint8_input": False}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    if meta.get("device", device.type) != device.type:
        raise ValueError(f"{path} was exported on {meta['device']}; export "
                         f"it again on {device.type}")
    module = torch.export.load(path).module()
    dtype = torch.uint8 if meta.get("uint8_input") else torch.float32

    @torch.inference_mode()
    def infer(x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(device=device, dtype=dtype)
        if meta.get("symbolic_batch") and x.shape[0] < MIN_BATCH:
            return module(x.repeat(MIN_BATCH, 1, 1, 1))[:x.shape[0]]
        return module(x)

    infer.meta = meta
    return infer
