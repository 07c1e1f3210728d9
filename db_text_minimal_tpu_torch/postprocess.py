"""Post-processing: probability maps -> rotated text boxes or polygons.

Counterpart of ``db_text_minimal_tpu/postprocess.py``: the device rect path
(``DeviceBoxRepresenter`` over ``ops.cc.device_boxes`` and the exact host
finishing ``finish_device_rects``), the device-assisted polygon path
(``DevicePolyRepresenter`` over ``ops.cc.device_poly_stats``) and the host
``SegDetectorRepresenter`` in both modes, which is the oracle each device
path is held against. Defaults mirror the reference: thresh 0.3, box_thresh
0.7, max_candidates 1000, unclip_ratio 1.5, min_size 3.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import geometry as geo
from .ops.cc import device_boxes, device_poly_stats
from .utils import profiling as P


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
        the device that runs the postprocess. While ``torch.profiler``
        records: the spans ``serve.device_boxes`` (K3–K6's launch),
        ``serve.boxes_to_host`` (the wait for the records) and
        ``serve.unclip`` (``finish_device_rects`` over the batch), and the
        counters ``serve.rects_in`` (records kept on the device, which the
        host finishes) and ``serve.boxes_out`` (boxes after the unclip and
        the size filter)."""
        if is_output_polygon:
            raise ValueError("DeviceBoxRepresenter gives rect mode only; "
                             "polygon mode runs in DevicePolyRepresenter "
                             "(device) or SegDetectorRepresenter (host)")
        if pred.dim() == 4:
            pred = pred[..., 0]
        height, width = pred.shape[1], pred.shape[2]
        with P.span("serve.device_boxes"):
            corners, scores, keep = device_boxes(
                pred, thresh=self.thresh, box_thresh=self.box_thresh,
                min_size=self.min_size, max_components=self.max_candidates)
        with P.span("serve.boxes_to_host"):
            corners, scores, keep = (t.cpu().numpy() for t in
                                     (corners, scores, keep))
        boxes_batch, scores_batch = [], []
        with P.span("serve.unclip"):
            P.count("serve.rects_in", keep.sum())
            for i in range(corners.shape[0]):
                dest_h, dest_w = batch["shape"][i]
                boxes, kept_scores = finish_device_rects(
                    corners[i][keep[i]], scores[i][keep[i]], width, height,
                    dest_w, dest_h, unclip_ratio=self.unclip_ratio,
                    min_size=self.min_size)
                boxes_batch.append(boxes)
                scores_batch.append(kept_scores)
            P.count("serve.boxes_out", sum(len(b) for b in boxes_batch))
        return boxes_batch, scores_batch


class DevicePolyRepresenter:
    """Polygon-mode postprocess with its first half on the prob map's
    device (``ops.cc.device_poly_stats``): threshold -> connected components
    -> per-component bbox and hole-filled mean prob, and the bitmap packed
    to 1 bit a pixel (32x less to copy to the host than the f32 map). The
    host unpacks it and runs the geometry of the host polygon path (contours,
    Douglas-Peucker, unclip), taking each contour's score from the component
    whose pixel bbox equals the contour's bbox.

    A contour with no such component is a hole border; the host path rejects
    it at the box_thresh gate whenever box_thresh > thresh (a hole's prob is
    at most thresh), so it is dropped here and box_thresh <= thresh is
    refused. Known divergences from the host path: a component nested in
    another's hole adds to the host's filled-contour mean of the outer one
    but not to its device score, and two components with bit-identical
    bboxes are paired with their contours in the JAX package's order (the
    last score of a bbox goes to its first contour)."""

    def __init__(self, thresh=0.3, box_thresh=0.7, max_candidates=1000,
                 unclip_ratio=1.5, min_size=3):
        if box_thresh <= thresh:
            raise ValueError(
                f"DevicePolyRepresenter requires box_thresh > thresh (got "
                f"box_thresh={box_thresh}, thresh={thresh}); use "
                f"SegDetectorRepresenter for this configuration")
        self.thresh = thresh
        self.box_thresh = box_thresh
        self.max_candidates = max_candidates
        self.unclip_ratio = unclip_ratio
        self.min_size = min_size

    def __call__(self, batch: dict, pred: torch.Tensor,
                 is_output_polygon: bool = True):
        """``pred``: NHWC (channel 0 is the prob map) or (N, H, W) tensor on
        the device that runs the first half. Returns per image a list of
        int64 (M, 2) polygons in the destination size and their scores."""
        if not is_output_polygon:
            raise ValueError("DevicePolyRepresenter gives polygon mode only; "
                             "rect mode runs in DeviceBoxRepresenter")
        if pred.dim() == 4:
            pred = pred[..., 0]
        stats = device_poly_stats(pred, thresh=self.thresh,
                                  max_components=self.max_candidates)
        return self.finish(batch, pred.shape[2],
                           *(t.cpu().numpy() for t in stats))

    def finish(self, batch: dict, width: int, packed, bboxes, scores, valid):
        """The host half over ``device_poly_stats``' outputs as numpy
        arrays, for maps ``width`` pixels wide."""
        height = packed.shape[1]
        boxes_batch, scores_batch = [], []
        for i in range(packed.shape[0]):
            dest_h, dest_w = batch["shape"][i]
            bitmap = np.unpackbits(packed[i], axis=-1)[:, :width]
            # several components may share one bbox: each keeps its score,
            # and each matched contour takes the last one left
            score_lut: dict = {}
            for bb, s, v in zip(bboxes[i], scores[i], valid[i]):
                if v:
                    score_lut.setdefault(tuple(bb), []).append(float(s))

            def score_of(contour, lut=score_lut):
                bucket = lut.get((int(contour[:, 0].min()),
                                  int(contour[:, 1].min()),
                                  int(contour[:, 0].max()),
                                  int(contour[:, 1].max())))
                return bucket.pop() if bucket else None

            boxes, kept = _polygons(bitmap, score_of, self, width, height,
                                    dest_w, dest_h)
            boxes_batch.append(boxes)
            scores_batch.append(kept)
        return boxes_batch, scores_batch


def _polygons(bitmap, score_of, rep, width, height, dest_w, dest_h):
    """The polygon geometry of the reference (``src/postprocess.py:54-104``)
    over a binary map, in its order of gates: contours -> Douglas-Peucker
    (at least 4 vertices) -> score (``score_of(contour)``; None drops the
    contour) -> box_thresh -> unclip to one loop -> min side of its
    min-area rect -> rescale to the destination size. ``rep`` gives
    box_thresh, unclip_ratio, min_size and max_candidates."""
    boxes, scores = [], []
    contours = geo.find_contours(bitmap.astype(np.uint8))
    for contour in contours[:rep.max_candidates]:
        contour = np.asarray(contour, dtype=np.float64)
        epsilon = 0.005 * geo.polygon_perimeter(contour)
        points = geo.approx_poly_dp(contour, epsilon)
        if points.shape[0] < 4:
            continue
        score = score_of(contour)
        if score is None or rep.box_thresh > score:
            continue
        expanded = _unclip(points, rep.unclip_ratio)
        if len(expanded) != 1:
            continue
        box = np.asarray(expanded[0], dtype=np.float64).reshape(-1, 2)
        _, (w, h) = geo.min_area_rect(box)
        if min(w, h) < rep.min_size + 2:
            continue
        box[:, 0] = np.clip(np.round(box[:, 0] / width * dest_w), 0, dest_w)
        box[:, 1] = np.clip(np.round(box[:, 1] / height * dest_h), 0, dest_h)
        boxes.append(box.astype(np.int64))
        scores.append(score)
    return boxes, scores


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
    """Host postprocess of the reference (``src/postprocess.py:7-198``).
    Rect mode: contours -> minAreaRect -> filled-contour mean score ->
    unclip -> minAreaRect -> filters. Polygon mode: contours ->
    Douglas-Peucker -> filled-contour mean score -> unclip -> filters."""

    def __init__(self, thresh=0.3, box_thresh=0.7, max_candidates=1000,
                 unclip_ratio=1.5):
        self.min_size = 3
        self.thresh = thresh
        self.box_thresh = box_thresh
        self.max_candidates = max_candidates
        self.unclip_ratio = unclip_ratio

    def __call__(self, batch: dict, pred, is_output_polygon: bool = False):
        """``pred``: NHWC array, channel 0 the prob map; ``batch['shape']``
        lists each image's destination (H, W). In rect mode rejected
        contours keep a zero entry, as in the reference; polygon mode gives
        a list of int64 (M, 2) polygons per image."""
        pred = np.asarray(pred)[..., 0]
        segmentation = pred > self.thresh
        from_bitmap = (self.polygons_from_bitmap if is_output_polygon
                       else self.boxes_from_bitmap)
        boxes_batch, scores_batch = [], []
        for i in range(pred.shape[0]):
            height, width = batch["shape"][i]
            boxes, scores = from_bitmap(pred[i], segmentation[i], width,
                                        height)
            boxes_batch.append(boxes)
            scores_batch.append(scores)
        return boxes_batch, scores_batch

    def polygons_from_bitmap(self, pred, bitmap, dest_width, dest_height):
        """``src/postprocess.py:54-104``: each contour scored by the mean
        prob inside it."""
        height, width = bitmap.shape
        return _polygons(bitmap, lambda c: self.box_score_fast(pred, c),
                         self, width, height, dest_width, dest_height)

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
