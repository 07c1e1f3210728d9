"""Serving handler: preprocess -> inference -> postprocess.

Counterpart of ``db_text_minimal_tpu/serve/handler.py``: request bytes ->
PIL decode -> aspect resize and pad to the 640² canvas -> uint8 batch to the
device, Caffe mean subtracted there -> ``FusedDBHead`` model forward ->
per-image JSON. Modes: ``masks`` (prob/thresh masks ×255 as nested lists),
``masks_png`` (the same masks as base64 PNGs) and ``boxes`` (the device rect
postprocess; only K box records per image leave the device).

``infer_mode`` selects the forward, under the JAX package's names:
``"folded"`` (the default) the weight-exact BN-folded forward, ``"int8"``
that with the wide convs int8 at dynamic scales, the fused head's conv1
included (``models/quant_infer``; flagship resnet18 + FPN only), ``"flax"``
the plain fused-head module, in ``dtype`` (by default bfloat16 on CUDA and
float32 on the CPU, as ``cli.common.load_model``). The folded modes serve box mode through the
prob-only forward (the thresh branch is skipped) and the masks modes
through the two-map one.

A ``forward`` given to the constructor is served as it is, in place of a
checkpoint (JAX handler.py:33-45): it maps the uint8 NHWC batch of
``preprocess`` to NHWC maps, and box mode reads its channel 0. With it,
any detector family is served (``cli.common.load_model`` builds every one;
the folded modes are resnet18 + FPN only).

A ``model_path`` ending in ``.pt2`` serves that export (``serve/export``),
as the JAX handler serves a ``.stablehlo`` artifact: ``infer_mode`` and
``dtype`` are then ignored (the archive holds its own forward), uint8
batches go up as they are, a legacy float-input export gets the means
subtracted on the host, and a ``prob_only`` export refuses the masks
modes.
"""

from __future__ import annotations

import functools
import io
from typing import Any

import numpy as np
import torch

from ..cli.common import (INFER_MODES, load_model, load_state_dict,
                          make_folded_forward)
from ..postprocess import DeviceBoxRepresenter
from ..utils import CAFFE_MEAN, resolve_device, test_resize


class DBTextDetectionHandler:
    def __init__(self, model_path: str | None = None, forward=None,
                 infer_mode: str = "folded", device="cuda",
                 dtype: torch.dtype | None = None):
        """The model is loaded from ``model_path`` at the first request (or
        by ``initialize``), unless ``forward`` is given, which is then
        served (``model_path`` is ignored). The default device is CUDA; on
        a machine without a GPU, ``device="cpu"`` must be passed.
        ``dtype`` is the flax mode's compute dtype (``load_model``'s
        default when None)."""
        if infer_mode not in INFER_MODES:
            raise ValueError(f"infer_mode {infer_mode!r} is not one of "
                             f"{INFER_MODES}")
        self.device = resolve_device(device)
        self.model_path = model_path
        self.infer_mode = infer_mode
        self.dtype = dtype
        self.box_representer = DeviceBoxRepresenter()
        self._forward = forward
        self._forward_prob = None   # prob-only forward for box mode
        self._prob_only = False     # a prob-only export: no thresh map
        self.initialized = forward is not None

    def initialize(self) -> None:
        if self.model_path.endswith(".pt2"):
            self._initialize_export()
            return
        mean = torch.tensor(CAFFE_MEAN, dtype=torch.float32,
                            device=self.device)
        if self.infer_mode == "flax":
            maps = load_model(self.model_path, device=self.device,
                              fuse_head=True, dtype=self.dtype)
            prob = None
        else:
            maps = make_folded_forward(
                load_state_dict(self.model_path, fuse_head=True),
                quantize=self.infer_mode == "int8", device=self.device)
            prob = functools.partial(maps, prob_only=True)

        def on_device(fwd):
            @torch.inference_mode()
            def forward(batch: np.ndarray) -> torch.Tensor:
                # uint8 upload; the mean is subtracted on the device (4x
                # less host-to-device traffic than float32)
                x = torch.from_numpy(np.ascontiguousarray(batch)).to(
                    self.device)
                return fwd(x.float() - mean)
            return forward

        self._forward = on_device(maps)
        self._forward_prob = prob and on_device(prob)
        self.initialized = True

    def _initialize_export(self) -> None:
        from .export import load_exported

        infer = load_exported(self.model_path, device=self.device)
        self._prob_only = bool(infer.meta.get("prob_only"))
        if infer.meta.get("uint8_input"):
            self._forward = infer
        else:
            # a legacy export traced on mean-subtracted float input
            mean = np.asarray(CAFFE_MEAN, np.float32)
            self._forward = lambda batch: infer(
                np.asarray(batch, np.float32) - mean)
        self.initialized = True

    def preprocess(self, request: list[dict[str, Any]]) -> np.ndarray:
        """bytes -> uint8 NHWC batch on the 640² canvas."""
        from PIL import Image

        imgs = []
        for data in request:
            image = data.get("data")
            if image is None:
                image = data.get("body")
            arr = np.array(Image.open(io.BytesIO(image)).convert("RGB"))
            imgs.append(test_resize(arr, size=640, pad=True)[None])
        return np.concatenate(imgs, axis=0)

    def inference(self, img: np.ndarray, prob_only: bool = False
                  ) -> torch.Tensor:
        """The maps of a uint8 batch; ``prob_only`` takes the folded
        modes' prob-only forward (the flax mode has none)."""
        if prob_only and self._forward_prob is not None:
            return self._forward_prob(img)
        return self._forward(img)

    def postprocess(self, data: torch.Tensor) -> list[dict]:
        """Maps ×255 as JSON-able nested lists."""
        res = []
        for pred in data.cpu().numpy():
            res.append({
                "prob_mask": (pred[..., 0] * 255).astype(np.uint8).tolist(),
                "thresh_mask": (pred[..., 1] * 255).astype(np.uint8).tolist()})
        return res

    def postprocess_png(self, data: torch.Tensor) -> list[dict]:
        """The same masks as base64 PNGs."""
        import base64

        from PIL import Image

        res = []
        for pred in data.cpu().numpy():
            entry = {}
            for key, ch in (("prob_png", 0), ("thresh_png", 1)):
                mask = (pred[..., ch] * 255).astype(np.uint8)
                buf = io.BytesIO()
                Image.fromarray(mask, mode="L").save(buf, format="PNG")
                entry[key] = base64.b64encode(buf.getvalue()).decode("ascii")
            res.append(entry)
        return res

    def postprocess_boxes(self, data: torch.Tensor) -> list[dict]:
        """Box mode: ``DeviceBoxRepresenter`` on the maps' device (one
        batched pass: threshold -> connected components -> oriented
        min-rects), then the exact host unclip of the K kept rects per
        image, in canvas coordinates."""
        n, height, width = data.shape[:3]
        boxes, scores = self.box_representer(
            {"shape": [(height, width)] * n}, data)
        return [{"boxes": [np.asarray(q, float).tolist() for q in b],
                 "scores": s.astype(float).tolist()}
                for b, s in zip(boxes, scores)]

    def handle(self, request: list[dict[str, Any]], mode: str = "masks"):
        if not self.initialized:
            self.initialize()
        if request is None:
            return None
        if mode != "boxes" and self._prob_only:
            raise ValueError(
                "this export was built with --prob_only (no thresh map); "
                "masks/masks_png modes need a 2-channel graph: use "
                "mode=boxes or re-export without --prob_only")
        batch = self.preprocess(request)
        if mode == "boxes":
            # only K box records per image leave the device
            return self.postprocess_boxes(self.inference(batch,
                                                         prob_only=True))
        preds = self.inference(batch)
        if mode == "masks_png":
            return self.postprocess_png(preds)
        return self.postprocess(preds)
