"""ICDAR15-style IoU-Pascal box evaluation.

Port of ``db_text_minimal_tpu/metrics/iou.py`` over the port's geometry
bindings: the polygon validity gate, don't-care filtering (a prediction is
dropped when its overlap with an ignored GT exceeds
``area_precision_constraint``), greedy first-come one-to-one matching above
``iou_constraint``, and global micro-averaged P/R/Hmean.
"""

from __future__ import annotations

import numpy as np

from ..ops import geometry as geo


def _valid(points) -> bool:
    pts = np.asarray(points, dtype=np.float64)
    return pts.shape[0] >= 3 and geo.polygon_is_simple(pts)


def polygon_iou(poly_a, poly_b) -> float:
    inter = geo.intersection_area(poly_a, poly_b)
    union = geo.union_area(poly_a, poly_b)
    return inter / union if union > 0 else 0.0


class DetectionIoUEvaluator:
    """Per-image IoU-Pascal matching and its micro-averaged combination."""

    def __init__(self, iou_constraint: float = 0.5,
                 area_precision_constraint: float = 0.5):
        self.iou_constraint = iou_constraint
        self.area_precision_constraint = area_precision_constraint

    def evaluate_image(self, gt, pred):
        gt_pols, gt_dont_care = [], []
        for item in gt:
            if not _valid(item["points"]):
                continue
            gt_pols.append(item["points"])
            if item.get("ignore", False):
                gt_dont_care.append(len(gt_pols) - 1)

        det_pols, det_dont_care = [], []
        for item in pred:
            if not _valid(item["points"]):
                continue
            det_pols.append(item["points"])
            if gt_dont_care:
                det_area = geo.polygon_area(item["points"])
                for idx in gt_dont_care:
                    inter = geo.intersection_area(gt_pols[idx],
                                                  item["points"])
                    prec = 0 if det_area == 0 else inter / det_area
                    if prec > self.area_precision_constraint:
                        det_dont_care.append(len(det_pols) - 1)
                        break

        det_matched = 0
        pairs = []
        iou_mat = np.empty((1, 1))
        if gt_pols and det_pols:
            iou_mat = np.array([[polygon_iou(d, g) for d in det_pols]
                                for g in gt_pols])
            gt_matched = np.zeros(len(gt_pols), np.int8)
            det_matched_mask = np.zeros(len(det_pols), np.int8)
            for gt_num in range(len(gt_pols)):
                for det_num in range(len(det_pols)):
                    if (gt_matched[gt_num] == 0
                            and det_matched_mask[det_num] == 0
                            and gt_num not in gt_dont_care
                            and det_num not in det_dont_care
                            and iou_mat[gt_num, det_num]
                            > self.iou_constraint):
                        gt_matched[gt_num] = 1
                        det_matched_mask[det_num] = 1
                        det_matched += 1
                        pairs.append({"gt": gt_num, "det": det_num})

        num_gt_care = len(gt_pols) - len(gt_dont_care)
        num_det_care = len(det_pols) - len(det_dont_care)
        if num_gt_care == 0:
            recall = 1.0
            precision = 0.0 if num_det_care > 0 else 1.0
        else:
            recall = det_matched / num_gt_care
            precision = 0.0 if num_det_care == 0 else \
                det_matched / num_det_care
        hmean = 0.0 if precision + recall == 0 else \
            2.0 * precision * recall / (precision + recall)

        return {
            "precision": precision,
            "recall": recall,
            "hmean": hmean,
            "pairs": pairs,
            "iouMat": [] if len(det_pols) > 100 else iou_mat.tolist(),
            "gtPolPoints": gt_pols,
            "detPolPoints": det_pols,
            "gtCare": num_gt_care,
            "detCare": num_det_care,
            "gtDontCare": gt_dont_care,
            "detDontCare": det_dont_care,
            "detMatched": det_matched,
        }

    def combine_results(self, results):
        num_gt = sum(r["gtCare"] for r in results)
        num_det = sum(r["detCare"] for r in results)
        matched = sum(r["detMatched"] for r in results)
        recall = 0 if num_gt == 0 else matched / num_gt
        precision = 0 if num_det == 0 else matched / num_det
        hmean = 0 if recall + precision == 0 else \
            2 * recall * precision / (recall + precision)
        return {"precision": precision, "recall": recall, "hmean": hmean}
