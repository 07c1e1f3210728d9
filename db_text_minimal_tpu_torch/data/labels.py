"""DB ground-truth maps: shrink masks and border (threshold) maps.

Port of ``db_text_minimal_tpu/data/labels.py``, over the port's geometry
bindings:
- polygon shrink by ``d = A(1−r²)/L`` with round joins, giving the prob map
  and the supervision mask (ignored, too small or failed shrinks are masked
  out);
- ``draw_thresh_map``: the polygon dilated by d, the per-pixel distance to
  its boundary inside the dilated bbox, max-fused into the canvas; the
  threshold mask (text_area_map) is the dilated polygon filled.
"""

from __future__ import annotations

import numpy as np

from ..ops import geometry as geo


def shrink_polygon(poly: np.ndarray, shrink_ratio: float = 0.4):
    """Shrink by d = A(1−r²)/L. Returns the shrunk polygon (int array) or
    None when the offset collapses."""
    area = geo.polygon_area(poly)
    length = geo.polygon_perimeter(poly)
    if area < 1e-6 or length < 1e-6:
        return None
    distance = area * (1 - np.power(shrink_ratio, 2)) / length
    shrinked = geo.offset_polygon(poly, -distance)
    if not shrinked:
        return None
    first = np.asarray(shrinked[0]).reshape(-1, 2)
    if first.shape[0] <= 2 or not geo.polygon_is_simple(first):
        return None
    return first


def draw_thresh_map(poly, canvas: np.ndarray, mask: np.ndarray,
                    shrink_ratio: float = 0.4) -> None:
    """In-place update of the threshold canvas (normalised inverse distance,
    max-fused) and the threshold mask (dilated polygon filled with 1)."""
    polygon = np.array(poly, dtype=np.float64)
    if polygon.ndim != 2 or polygon.shape[1] != 2:
        raise ValueError(f"poly must be (n, 2), got {polygon.shape}")
    area = geo.polygon_area(polygon)
    length = geo.polygon_perimeter(polygon)
    if area <= 0 or length <= 0:
        return
    distance = area * (1 - np.power(shrink_ratio, 2)) / length
    padded = geo.offset_polygon(polygon, distance)
    if not padded:
        return
    padded_polygon = np.asarray(padded[0], dtype=np.float64)
    geo.fill_poly(mask, padded_polygon, 1.0)

    xmin = int(padded_polygon[:, 0].min())
    xmax = int(padded_polygon[:, 0].max())
    ymin = int(padded_polygon[:, 1].min())
    ymax = int(padded_polygon[:, 1].max())
    width = xmax - xmin + 1
    height = ymax - ymin + 1

    shifted = polygon.copy()
    shifted[:, 0] -= xmin
    shifted[:, 1] -= ymin

    # distance_map = min over edges of clipped normalized distance
    distance_map = geo.border_distance_field(shifted, height, width, distance)

    xmin_valid = min(max(0, xmin), canvas.shape[1] - 1)
    xmax_valid = min(max(0, xmax), canvas.shape[1] - 1)
    ymin_valid = min(max(0, ymin), canvas.shape[0] - 1)
    ymax_valid = min(max(0, ymax), canvas.shape[0] - 1)
    canvas[ymin_valid:ymax_valid + 1, xmin_valid:xmax_valid + 1] = np.fmax(
        1 - distance_map[ymin_valid - ymin:ymax_valid - ymin + 1,
                         xmin_valid - xmin:xmax_valid - xmin + 1],
        canvas[ymin_valid:ymax_valid + 1, xmin_valid:xmax_valid + 1])


def make_gt_maps(anns, image_size: int, ignore_tags: list[str],
                 min_text_size: int = 8, shrink_ratio: float = 0.4,
                 thresh_min: float = 0.3, thresh_max: float = 0.7):
    """The four GT maps of one sample from its annotations (dicts with
    ``poly`` and ``text``). Returns (prob_map, supervision_mask, thresh_map,
    text_area_map, per_ann_ignore)."""
    gt = np.zeros((image_size, image_size), dtype=np.float32)
    mask = np.ones((image_size, image_size), dtype=np.float32)
    thresh_map = np.zeros((image_size, image_size), dtype=np.float32)
    thresh_mask = np.zeros((image_size, image_size), dtype=np.float32)

    ignore_flags = []
    for ann in anns:
        poly = np.array(ann["poly"])
        height = poly[:, 1].max() - poly[:, 1].min()
        width = poly[:, 0].max() - poly[:, 0].min()
        if (geo.polygon_area(poly) < 1
                or min(height, width) < min_text_size
                or ann["text"] in ignore_tags):
            ignore_flags.append(True)
            geo.fill_poly(mask, poly.astype(np.float64), 0.0)
            continue
        shrinked = shrink_polygon(poly, shrink_ratio)
        if shrinked is None:
            ignore_flags.append(True)
            geo.fill_poly(mask, poly.astype(np.float64), 0.0)
            continue
        ignore_flags.append(False)
        geo.fill_poly(gt, shrinked.astype(np.float64), 1.0)
        draw_thresh_map(ann["poly"], thresh_map, thresh_mask,
                        shrink_ratio=shrink_ratio)

    thresh_map = thresh_map * (thresh_max - thresh_min) + thresh_min
    return gt, mask, thresh_map, thresh_mask, ignore_flags
