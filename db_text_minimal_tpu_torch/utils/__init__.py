"""Shared helpers: image reading and preprocessing, padding to a multiple,
box drawing, device selection, seeding, logging and a call timer.

Counterpart of ``db_text_minimal_tpu/utils/__init__.py`` and of
``filter_zero_boxes`` in ``utils/visualize.py``. The overlays are in
``utils/visualize.py``, the profiler trace and the program's spans and
counters in ``utils/profiling.py``. The Caffe means
``[103.939, 116.779, 123.68]`` are subtracted from images in RGB channel
order, exactly as the reference does (BGR means applied to RGB data); the
quirk is kept for checkpoint parity.
"""

from __future__ import annotations

import functools
import logging
import os
import random
import time

import numpy as np
import torch

CAFFE_MEAN = (103.939, 116.779, 123.68)


def str_to_bool(value: str) -> bool:
    if value.lower() in {"false", "f", "0", "no", "n"}:
        return False
    if value.lower() in {"true", "t", "1", "yes", "y"}:
        return True
    raise ValueError("{} is not a valid boolean value".format(value))


def minmax_scaler_img(img: np.ndarray) -> np.ndarray:
    """An array scaled to uint8 over its own range (all zeros when the
    range is 0)."""
    img = np.asarray(img)
    rng = img.max() - img.min()
    if rng == 0:
        return np.zeros_like(img, dtype="uint8")
    return ((img - img.min()) * (1 / rng * 255)).astype("uint8")


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


def read_img(img_fp: str):
    """An image file as an RGB uint8 array, with its height and width."""
    import cv2

    img = cv2.imread(img_fp)
    if img is None:
        raise FileNotFoundError(img_fp)
    img = img[:, :, ::-1]
    h_origin, w_origin, _ = img.shape
    return img, h_origin, w_origin


def test_preprocess(img: np.ndarray, mean=CAFFE_MEAN, pad: bool = False,
                    size: int = 640) -> np.ndarray:
    """Inference preprocessing: ``test_resize``, the means subtracted in
    float32, a batch axis added. Returns float32 (1, H, W, 3)."""
    img = test_resize(img, size=size, pad=pad).astype(np.float32)
    img = img - np.asarray(mean, dtype=np.float32)
    return np.expand_dims(img, axis=0)


def pad_to_multiple(img: np.ndarray, multiple: int = 32):
    """An NHWC or HWC image zero-padded at the bottom and right so that H
    and W are multiples of ``multiple`` (the backbone's stride 32), and
    the original (H, W)."""
    h, w = img.shape[-3:-1]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return img, (h, w)
    pad_width = [(0, 0)] * (img.ndim - 3) + [(0, ph), (0, pw), (0, 0)]
    return np.pad(img, pad_width), (h, w)


def timer(func):
    """Decorator that prints the wall-clock seconds of each call of
    ``func``."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        start = time.time()
        result = func(*args, **kwargs)
        end = time.time()
        print(">>> Function {}: {}'s".format(func.__name__, end - start))
        return result

    return wrapper


def filter_zero_boxes(box_list, score_list, is_output_polygon: bool):
    """Drop the all-zero entries that rect mode leaves for rejected
    contours (and any all-zero polygon)."""
    if len(box_list) == 0:
        return [], []
    if is_output_polygon:
        keep = [np.asarray(b).sum() > 0 for b in box_list]
        return ([b for b, k in zip(box_list, keep) if k],
                [s for s, k in zip(score_list, keep) if k])
    box_arr = np.asarray(box_list)
    keep = np.abs(box_arr.reshape(box_arr.shape[0], -1)).sum(axis=1) > 0
    return box_arr[keep], np.asarray(score_list)[keep]


def draw_bbox(img, result, color=(255, 0, 0), thickness=3):
    """Draw each box or polygon of ``result`` as a closed polyline on a
    copy of the RGB image ``img`` (or of the image file it names)."""
    import cv2

    if isinstance(img, str):
        img = cv2.imread(img)
    img = np.ascontiguousarray(np.asarray(img).copy())
    for point in result:
        point = np.asarray(point).astype(int)
        cv2.polylines(img, [point], True, color, thickness)
    return img


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


def setup_determinism(seed: int = 42) -> torch.Generator:
    """Seed Python's and numpy's global generators and return a CPU
    ``torch.Generator`` seeded alike, which the caller passes to whatever
    draws random weights."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


def setup_logger(logger_name: str = "dbtext-torch",
                 log_file_path: str | None = None) -> logging.Logger:
    """A DEBUG logger with one console handler and, when ``log_file_path``
    is given, one file handler."""
    logger = logging.getLogger(logger_name)
    formatter = logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s: %(message)s")
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        stream = logging.StreamHandler()
        stream.setFormatter(formatter)
        logger.addHandler(stream)
    if log_file_path is not None and not any(
            isinstance(h, logging.FileHandler) for h in logger.handlers):
        file_handle = logging.FileHandler(log_file_path)
        file_handle.setFormatter(formatter)
        logger.addHandler(file_handle)
    logger.setLevel(logging.DEBUG)
    return logger
