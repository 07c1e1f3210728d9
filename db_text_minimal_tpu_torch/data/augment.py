"""Training-time augmentation: flip, rotate and scale, the text-safe crop
and the square resize-pad, each carrying the polygons along.

Port of ``db_text_minimal_tpu/data/augment.py`` (numpy and cv2), which
replaces the reference's imgaug pipeline (``src/data_loaders.py:58-64``:
``Fliplr(0.5)``, ``Affine(rotate +-10)``, ``Resize(0.5-3.0)``, with the
keypoint transforms of ``src/db_transforms.py:85-99``) and ports its
text-safe crop (``src/db_transforms.py:102-182``) and square resize
(``:185-200``). Every draw from ``rng`` happens in the JAX module's order,
so the same ``RandomState`` gives the same image and polygons.
"""

from __future__ import annotations

import numpy as np


def _transform_keypoints(anns, matrix, w, h):
    """Apply a 2×3 affine to polygon points, then clamp into the image like
    the reference does post-augment (``src/db_transforms.py:94-96``)."""
    new_anns = []
    for ann in anns:
        poly = np.asarray(ann["poly"], dtype=np.float64)
        pts = poly @ matrix[:, :2].T + matrix[:, 2]
        pts[:, 0] = np.clip(pts[:, 0], 0, w - 1)
        pts[:, 1] = np.clip(pts[:, 1], 0, h - 1)
        new_anns.append({"poly": pts.tolist(), "text": ann["text"]})
    return new_anns


def random_flip_rotate_resize(rng: np.random.RandomState, img: np.ndarray,
                              anns, flip_prob: float = 0.5,
                              rotate_range: tuple = (-10, 10),
                              resize_range: tuple = (0.5, 3.0),
                              max_side: int = 2560):
    """imgaug ``Sequential([Fliplr, Affine(rotate), Resize])`` equivalent.
    One scale factor is sampled per image and applied to both axes (imgaug
    ``Resize((lo, hi))`` semantics). ``max_side`` caps the upscale so a 3×
    resize of a large photo cannot explode host memory (the subsequent
    pipeline stage crops/resizes to ``image_size`` anyway)."""
    import cv2

    h, w = img.shape[:2]

    # Fliplr(0.5)
    if rng.rand() < flip_prob:
        img = img[:, ::-1].copy()
        m = np.array([[-1.0, 0.0, w - 1], [0.0, 1.0, 0.0]])
        anns = _transform_keypoints(anns, m, w, h)

    # Affine(rotate ±10°) about the image center, same output size
    angle = rng.uniform(*rotate_range)
    center = ((w - 1) / 2.0, (h - 1) / 2.0)
    m = cv2.getRotationMatrix2D(center, angle, 1.0)
    img = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR,
                         borderValue=0)
    anns = _transform_keypoints(anns, m, w, h)

    # Resize(0.5–3.0): one factor for both axes
    scale = rng.uniform(*resize_range)
    scale = min(scale, max_side / max(h, w))
    nh, nw = max(int(h * scale), 4), max(int(w * scale), 4)
    img = cv2.resize(img, (nw, nh))
    m = np.array([[nw / w, 0.0, 0.0], [0.0, nh / h, 0.0]])
    anns = _transform_keypoints(anns, m, nw, nh)
    return img, anns


def _split_regions(axis: np.ndarray):
    """``src/db_transforms.py:102-111``."""
    regions = []
    min_axis_index = 0
    for i in range(1, axis.shape[0]):
        if axis[i] != axis[i - 1] + 1:
            regions.append(axis[min_axis_index:i])
            min_axis_index = i
    return regions


def _random_select(rng, axis):
    xx = rng.choice(axis, size=2)
    return np.min(xx), np.max(xx)


def _region_wise_random_select(rng, regions):
    indices = list(rng.choice(len(regions), 2))
    values = [int(rng.choice(regions[i], size=1)[0]) for i in indices]
    return min(values), max(values)


def crop(rng: np.random.RandomState, image: np.ndarray, anns,
         max_tries: int = 10, min_crop_side_ratio: float = 0.1):
    """Text-safe random crop (``src/db_transforms.py:132-182``): pick crop
    bounds from rows/columns free of text so no polygon is cut."""
    h, w = image.shape[:2]
    h_array = np.zeros(h, dtype=np.int32)
    w_array = np.zeros(w, dtype=np.int32)
    for ann in anns:
        points = np.round(ann["poly"], decimals=0).astype(np.int32)
        minx, maxx = points[:, 0].min(), points[:, 0].max()
        miny, maxy = points[:, 1].min(), points[:, 1].max()
        w_array[max(minx, 0):max(maxx, 0)] = 1
        h_array[max(miny, 0):max(maxy, 0)] = 1
    h_axis = np.where(h_array == 0)[0]
    w_axis = np.where(w_array == 0)[0]
    if len(h_axis) == 0 or len(w_axis) == 0:
        return image, anns

    h_regions = _split_regions(h_axis)
    w_regions = _split_regions(w_axis)

    for _ in range(max_tries):
        if len(w_regions) > 1:
            xmin, xmax = _region_wise_random_select(rng, w_regions)
        else:
            xmin, xmax = _random_select(rng, w_axis)
        if len(h_regions) > 1:
            ymin, ymax = _region_wise_random_select(rng, h_regions)
        else:
            ymin, ymax = _random_select(rng, h_axis)
        if (xmax - xmin < min_crop_side_ratio * w
                or ymax - ymin < min_crop_side_ratio * h):
            continue
        new_anns = []
        for ann in anns:
            poly = np.array(ann["poly"])
            if not (poly[:, 0].min() > xmax or poly[:, 0].max() < xmin
                    or poly[:, 1].min() > ymax or poly[:, 1].max() < ymin):
                poly[:, 0] = np.clip(poly[:, 0] - xmin, 0.0,
                                     (xmax - xmin - 1) * 1.0)
                poly[:, 1] = np.clip(poly[:, 1] - ymin, 0.0,
                                     (ymax - ymin - 1) * 1.0)
                new_anns.append({"poly": poly.tolist(), "text": ann["text"]})
        if new_anns:
            return image[ymin:ymax, xmin:xmax], new_anns
    return image, anns


def resize_square_pad(size: int, image: np.ndarray, anns):
    """Aspect-preserving resize into the top-left of a ``size×size`` zero
    canvas with polygon rescale (``src/db_transforms.py:185-200``)."""
    import cv2

    h, w, c = image.shape
    scale = min(size / w, size / h)
    nh, nw = int(h * scale), int(w * scale)
    padimg = np.zeros((size, size, c), image.dtype)
    padimg[:nh, :nw] = cv2.resize(image, (nw, nh))
    new_anns = []
    for ann in anns:
        poly = np.array(ann["poly"], dtype=np.float64) * scale
        new_anns.append({"poly": poly.tolist(), "text": ann["text"]})
    return padimg, new_anns
