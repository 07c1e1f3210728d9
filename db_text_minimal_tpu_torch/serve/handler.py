"""Serving handler: preprocess -> inference -> postprocess.

Counterpart of ``db_text_minimal_tpu/serve/handler.py``: request bytes ->
PIL decode -> aspect resize and pad to the 640² canvas -> uint8 batch to the
device, Caffe mean subtracted there -> ``FusedDBHead`` model forward ->
per-image JSON. Modes: ``masks`` (prob/thresh masks ×255 as nested lists),
``masks_png`` (the same masks as base64 PNGs) and ``boxes`` (the device rect
postprocess; only K box records per image leave the device).

The model path is the plain fused-head module (the JAX package's
``infer_mode="flax"``). The BN-folded and int8 forwards are not ported yet.
"""

from __future__ import annotations

import io
from typing import Any

import numpy as np
import torch

from ..postprocess import DeviceBoxRepresenter
from ..utils import CAFFE_MEAN, resolve_device, test_resize

_NOT_PORTED = ("infer_mode {!r} (BN-folded / int8 forward) is not ported "
               "yet: ROADMAP item 13")


class DBTextDetectionHandler:
    def __init__(self, model_path: str, infer_mode: str = "module",
                 device="cuda"):
        """The model is loaded from ``model_path`` at the first request (or
        by ``initialize``). The default device is CUDA; on a machine without
        a GPU, ``device="cpu"`` must be passed."""
        if infer_mode != "module":
            raise NotImplementedError(_NOT_PORTED.format(infer_mode))
        self.device = resolve_device(device)
        self.model_path = model_path
        self.box_representer = DeviceBoxRepresenter()
        self._forward = None
        self.initialized = False

    def initialize(self) -> None:
        from ..cli.common import load_model

        model = load_model(self.model_path, device=self.device,
                           fuse_head=True)
        mean = torch.tensor(CAFFE_MEAN, dtype=torch.float32,
                            device=self.device)

        @torch.inference_mode()
        def forward(batch: np.ndarray) -> torch.Tensor:
            # uint8 upload; the mean is subtracted on the device (4x less
            # host-to-device traffic than float32)
            x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
            return model(x.float() - mean)

        self._forward = forward
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

    def inference(self, img: np.ndarray) -> torch.Tensor:
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
        batch = self.preprocess(request)
        preds = self.inference(batch)
        if mode == "boxes":
            return self.postprocess_boxes(preds)
        if mode == "masks_png":
            return self.postprocess_png(preds)
        return self.postprocess(preds)
