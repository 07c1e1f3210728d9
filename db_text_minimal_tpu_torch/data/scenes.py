"""Synthetic text scenes made in numpy, for smoke runs and tests.

Each sample is a textured-noise image with 4 to 8 text polygons, rotated
rectangles or curved bands, filled with ``geometry.fill_poly``; about one in
eight carries the ignore tag ``###``. Its GT maps come from
``labels.make_gt_maps`` in the compact layout that
``train.trainer.device_preprocess`` unpacks: a uint8 image, the three binary
maps bit-packed along the width with ``np.packbits`` and the threshold map
in float16. No cv2 and no image file.
"""

from __future__ import annotations

import numpy as np

from ..ops import geometry as geo
from .datasets import _stack_batch
from .labels import make_gt_maps

IGNORE_TAGS = ["###"]


def _rotated_rect(rng: np.random.RandomState, size: int) -> np.ndarray:
    w = rng.uniform(size / 10, size / 3)
    h = rng.uniform(size / 40, size / 12)
    cx, cy = rng.uniform(w / 2 + 2, size - w / 2 - 2, 2)
    th = rng.uniform(-np.pi / 5, np.pi / 5)
    c, s = np.cos(th), np.sin(th)
    corners = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
    return corners @ np.array([[c, s], [-s, c]]) + [cx, cy]


def _curved_band(rng: np.random.RandomState, size: int) -> np.ndarray:
    radius = rng.uniform(size / 6, size / 3)
    thick = rng.uniform(size / 40, size / 14)
    span = rng.uniform(0.4, 1.0)
    start = rng.uniform(0, 2 * np.pi)
    cx, cy = rng.uniform(radius + 2, size - radius - 2, 2)
    angles = start + np.linspace(0, span, 7)
    outer = np.stack([cx + radius * np.cos(angles),
                      cy + radius * np.sin(angles)], 1)
    inner = np.stack([cx + (radius - thick) * np.cos(angles[::-1]),
                      cy + (radius - thick) * np.sin(angles[::-1])], 1)
    return np.concatenate([outer, inner])


def text_sample(rng: np.random.RandomState, size: int,
                index: int = 0) -> dict:
    """One compact-layout sample with its annotations."""
    coarse = rng.randint(0, 90, (size // 16 + 1, size // 16 + 1, 3))
    img = np.kron(coarse, np.ones((16, 16, 1)))[:size, :size]
    img = img + rng.randint(0, 40, (size, size, 3))
    anns = []
    for _ in range(rng.randint(4, 9)):
        poly = (_curved_band if rng.rand() < 0.4 else _rotated_rect)(rng,
                                                                      size)
        poly = np.round(poly).astype(np.int64)
        if not geo.polygon_is_simple(poly):
            continue
        area = np.zeros((size, size), np.float32)
        geo.fill_poly(area, poly.astype(np.float64), 1.0)
        color = rng.randint(150, 256, 3)
        img[area > 0] = color - rng.randint(0, 50, (int(area.sum()), 1))
        anns.append({"poly": poly,
                     "text": "###" if rng.rand() < 0.125 else "text"})
    gt, mask, thresh_map, thresh_mask, ignore = make_gt_maps(
        anns, size, IGNORE_TAGS)
    return {
        "image_path": f"scene-{index}",
        "img": np.clip(img, 0, 255).astype(np.uint8),
        "prob_map": np.packbits(gt.astype(bool), axis=-1),
        "supervision_mask": np.packbits(mask.astype(bool), axis=-1),
        "thresh_map": thresh_map.astype(np.float16),
        "text_area_map": np.packbits(thresh_mask.astype(bool), axis=-1),
        "anns": [a["poly"] for a in anns],
        "ignore_tags": ignore,
    }


def text_batch(seed: int, batch_size: int, size: int) -> dict:
    """A batch of ``text_sample``s drawn from ``seed``; ``size`` must be a
    multiple of 16."""
    if size % 16:
        raise ValueError(f"size {size} is not a multiple of 16")
    rng = np.random.RandomState(seed)
    return _stack_batch([text_sample(rng, size, i)
                         for i in range(batch_size)])
