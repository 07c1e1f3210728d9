"""Shared helpers: image preprocessing constants and device selection.

Counterpart of ``db_text_minimal_tpu/utils/__init__.py``. The Caffe means
``[103.939, 116.779, 123.68]`` are subtracted from images in RGB channel
order, exactly as the reference does (BGR means applied to RGB data); the
quirk is kept for checkpoint parity.
"""

from __future__ import annotations

import numpy as np
import torch

CAFFE_MEAN = (103.939, 116.779, 123.68)


def str_to_bool(value: str) -> bool:
    if value.lower() in {"false", "f", "0", "no", "n"}:
        return False
    if value.lower() in {"true", "t", "1", "yes", "y"}:
        return True
    raise ValueError("{} is not a valid boolean value".format(value))


def test_resize(img: np.ndarray, size: int = 640,
                pad: bool = False) -> np.ndarray:
    """Aspect-preserving resize so both sides are at most ``size``,
    optionally padded to a square canvas. An image already at the target
    size comes back unchanged, as ``cv2.resize`` to the same size gives it,
    without importing cv2."""
    h, w, c = img.shape
    scale = min(size / w, size / h)
    h = int(h * scale)
    w = int(w * scale)
    if (h, w) == img.shape[:2]:
        resized = img
    else:
        import cv2

        resized = cv2.resize(img, (w, h))
    if pad:
        new_img = np.zeros((size, size, c), img.dtype)
        new_img[:h, :w] = resized
        return new_img
    return resized


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default of every
    entry point; asking for it on a machine without a GPU raises instead of
    falling back to the CPU, which must be asked for by name."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return device
