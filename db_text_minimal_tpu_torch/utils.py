"""Shared helpers: preprocessing constants, device selection, seeding,
logging and step timing.

Counterpart of ``db_text_minimal_tpu/utils/__init__.py`` and of
``StepTimer`` in ``utils/profiling.py``. The Caffe means
``[103.939, 116.779, 123.68]`` are subtracted from images in RGB channel
order, exactly as the reference does (BGR means applied to RGB data); the
quirk is kept for checkpoint parity.
"""

from __future__ import annotations

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


class StepTimer:
    """Rolling throughput meter: ``tick(batch_size)`` per step, read
    ``images_per_sec``. The first ``warmup`` steps are not counted. On the
    card a step returns before the device finishes, so this is the rate at
    which steps are issued, which the device's rate bounds once its queue
    is full."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.steps = 0
        self.images = 0
        self.start = None

    def tick(self, batch_size: int) -> None:
        self.steps += 1
        if self.steps == self.warmup:
            self.start = time.perf_counter()
        elif self.steps > self.warmup:
            self.images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self.start is None or self.images == 0:
            return 0.0
        return self.images / (time.perf_counter() - self.start)
