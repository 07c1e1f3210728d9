"""Post-processing: probability maps -> rotated text boxes (rect mode).

Counterpart of ``db_text_minimal_tpu/postprocess.py``: the device rect path
(``DeviceBoxRepresenter`` over ``ops.cc.device_boxes`` and the exact host
finishing ``finish_device_rects``) and the host ``SegDetectorRepresenter``
in rect mode, which is the oracle the device path is held against.
Defaults mirror the reference: thresh 0.3, box_thresh 0.7, max_candidates
1000, unclip_ratio 1.5, min_size 3. Polygon mode is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import geometry as geo
from .ops.cc import device_boxes


class DeviceBoxRepresenter:
    """Rect-mode postprocess on the prob map's device: threshold ->
    connected components -> oriented min-rects -> filters
    (``ops.cc.device_boxes``); only N·K box records come to the host, which
    unclips them exactly and rescales (``finish_device_rects``). Same call
    contract as ``SegDetectorRepresenter`` in rect mode."""

    def __init__(self, thresh=0.3, box_thresh=0.7, max_candidates=1000,
                 unclip_ratio=1.5, min_size=3):
        # Slots follow the raster order of each component's root, so a cap
        # below the reference's 1000 drops real text behind noise speckles.
        # A component is scored over itself and its holes, as the host's
        # filled-outer-contour mean does.
        self.thresh = thresh
        self.box_thresh = box_thresh
        self.max_candidates = max_candidates
        self.unclip_ratio = unclip_ratio
        self.min_size = min_size

    def __call__(self, batch: dict, pred: torch.Tensor,
                 is_output_polygon: bool = False):
        """``pred``: NHWC (channel 0 is the prob map) or (N, H, W) tensor on
        the device that runs the postprocess."""
        if is_output_polygon:
            raise NotImplementedError("polygon mode is not ported yet")
        if pred.dim() == 4:
            pred = pred[..., 0]
        height, width = pred.shape[1], pred.shape[2]
        corners, scores, keep = device_boxes(
            pred, thresh=self.thresh, box_thresh=self.box_thresh,
            min_size=self.min_size, max_components=self.max_candidates)
        corners, scores, keep = (t.cpu().numpy() for t in
                                 (corners, scores, keep))
        boxes_batch, scores_batch = [], []
        for i in range(corners.shape[0]):
            dest_h, dest_w = batch["shape"][i]
            boxes, kept_scores = finish_device_rects(
                corners[i][keep[i]], scores[i][keep[i]], width, height,
                dest_w, dest_h, unclip_ratio=self.unclip_ratio,
                min_size=self.min_size)
            boxes_batch.append(boxes)
            scores_batch.append(kept_scores)
        return boxes_batch, scores_batch


def finish_device_rects(quads: np.ndarray, scores: np.ndarray,
                        width: int, height: int, dest_w: int, dest_h: int,
                        unclip_ratio: float = 1.5, min_size: int = 3):
    """Host finishing of PRE-unclip device rects: the exact unclip ->
    minAreaRect -> size filter -> order -> rescale sequence of the host
    rect path, so device boxes compare bit for bit with host boxes."""
    out, kept_scores = [], []
    for quad, score in zip(np.asarray(quads, np.float64),
                           np.asarray(scores, np.float32)):
        points = np.array(order_rect_points(quad))
        expanded = _unclip(points, unclip_ratio)
        if not expanded:
            continue
        corners2, (w2, h2) = geo.min_area_rect(
            np.asarray(expanded[0], np.float64))
        if min(w2, h2) < min_size + 2:
            continue
        box = np.array(order_rect_points(corners2))
        box[:, 0] = np.clip(np.round(box[:, 0] / width * dest_w), 0, dest_w)
        box[:, 1] = np.clip(np.round(box[:, 1] / height * dest_h), 0, dest_h)
        out.append(box.astype(np.int16))
        kept_scores.append(score)
    boxes = (np.stack(out) if out
             else np.zeros((0, 4, 2), dtype=np.int16))
    return boxes, np.asarray(kept_scores, np.float32)


def _unclip(box, unclip_ratio: float = 1.5):
    """Dilate by d = A·ratio/L (round-join offset)."""
    box = np.asarray(box, dtype=np.float64)
    area = geo.polygon_area(box)
    length = geo.polygon_perimeter(box)
    if length <= 0:
        return []
    return geo.offset_polygon(box, area * unclip_ratio / length)


def order_rect_points(corners: np.ndarray):
    """Clockwise-from-top-left ordering of 4 rect corners."""
    points = sorted(np.asarray(corners).tolist(), key=lambda x: x[0])
    i1, i4 = (0, 1) if points[1][1] > points[0][1] else (1, 0)
    i2, i3 = (2, 3) if points[3][1] > points[2][1] else (3, 2)
    return [points[i1], points[i2], points[i3], points[i4]]


class SegDetectorRepresenter:
    """Host postprocess of the reference (``src/postprocess.py:7-198``),
    rect mode: contours -> minAreaRect -> filled-contour mean score ->
    unclip -> minAreaRect -> filters."""

    def __init__(self, thresh=0.3, box_thresh=0.7, max_candidates=1000,
                 unclip_ratio=1.5):
        self.min_size = 3
        self.thresh = thresh
        self.box_thresh = box_thresh
        self.max_candidates = max_candidates
        self.unclip_ratio = unclip_ratio

    def __call__(self, batch: dict, pred, is_output_polygon: bool = False):
        """``pred``: NHWC array, channel 0 the prob map; ``batch['shape']``
        lists each image's destination (H, W). Rejected contours keep a
        zero entry, as in the reference."""
        if is_output_polygon:
            raise NotImplementedError("polygon mode is not ported yet")
        pred = np.asarray(pred)[..., 0]
        segmentation = pred > self.thresh
        boxes_batch, scores_batch = [], []
        for i in range(pred.shape[0]):
            height, width = batch["shape"][i]
            boxes, scores = self.boxes_from_bitmap(pred[i], segmentation[i],
                                                   width, height)
            boxes_batch.append(boxes)
            scores_batch.append(scores)
        return boxes_batch, scores_batch

    def boxes_from_bitmap(self, pred, bitmap, dest_width, dest_height):
        height, width = bitmap.shape
        contours = geo.find_contours(bitmap.astype(np.uint8))
        num_contours = min(len(contours), self.max_candidates)
        boxes = np.zeros((num_contours, 4, 2), dtype=np.int16)
        scores = np.zeros((num_contours,), dtype=np.float32)
        for index in range(num_contours):
            contour = np.asarray(contours[index], dtype=np.float64)
            corners, (w, h) = geo.min_area_rect(contour)
            if min(w, h) < self.min_size:
                continue
            points = np.array(order_rect_points(corners))
            score = self.box_score_fast(pred, contour)
            if self.box_thresh > score:
                continue
            expanded = _unclip(points, self.unclip_ratio)
            if not expanded:
                continue
            corners2, (w2, h2) = geo.min_area_rect(
                np.asarray(expanded[0], dtype=np.float64))
            if min(w2, h2) < self.min_size + 2:
                continue
            box = np.array(order_rect_points(corners2))
            box[:, 0] = np.clip(np.round(box[:, 0] / width * dest_width), 0,
                                dest_width)
            box[:, 1] = np.clip(np.round(box[:, 1] / height * dest_height),
                                0, dest_height)
            boxes[index] = box.astype(np.int16)
            scores[index] = score
        return boxes, scores

    def box_score_fast(self, bitmap: np.ndarray, box: np.ndarray) -> float:
        """Mean prob inside the contour's filled polygon within its bbox."""
        h, w = bitmap.shape[:2]
        box = np.asarray(box, dtype=np.float64).copy()
        xmin = int(np.clip(np.floor(box[:, 0].min()), 0, w - 1))
        xmax = int(np.clip(np.ceil(box[:, 0].max()), 0, w - 1))
        ymin = int(np.clip(np.floor(box[:, 1].min()), 0, h - 1))
        ymax = int(np.clip(np.ceil(box[:, 1].max()), 0, h - 1))
        mask = np.zeros((ymax - ymin + 1, xmax - xmin + 1), dtype=np.float32)
        box[:, 0] -= xmin
        box[:, 1] -= ymin
        geo.fill_poly(mask, box, 1.0)
        denom = mask.sum()
        if denom == 0:
            return 0.0
        window = bitmap[ymin:ymax + 1, xmin:xmax + 1]
        return float((window * mask).sum() / denom)
