"""DetEval box evaluation protocol.

Port of ``db_text_minimal_tpu/metrics/deteval.py`` over the port's geometry
bindings, the reference's ``src/deteval.py`` (:8-380) with identical
semantics: recall/precision overlap matrices, one-to-one matches
(with single-overlap and normalized-center-distance gates, :228-250),
one-to-many "split" matches (:253-285) and many-to-one "merge" matches
(:288-318), scored ``mtype_oo_o=1.0 / mtype_om_o=0.8 / mtype_om_m=1.0``;
accumulators combined across images as ``Σaccum / Σcare`` (:357-380).
Protocol constants: tr=0.8 recall, tp=0.4 precision (``Makefile:11-14``).
"""

from __future__ import annotations

import numpy as np

from ..ops import geometry as geo
from .iou import _valid


class DetectionDetEvalEvaluator:
    """Per-image DetEval matching and its combination across images."""

    def __init__(self, area_recall_constraint=0.8,
                 area_precision_constraint=0.4,
                 ev_param_ind_center_diff_thr=1,
                 mtype_oo_o=1.0, mtype_om_o=0.8, mtype_om_m=1.0):
        self.tr = area_recall_constraint
        self.tp = area_precision_constraint
        self.center_diff_thr = ev_param_ind_center_diff_thr
        self.mtype_oo_o = mtype_oo_o
        self.mtype_om_o = mtype_om_o
        self.mtype_om_m = mtype_om_m

    def evaluate_image(self, gt, pred):
        gt_rects, gt_dont_care = [], []
        for item in gt:
            if not _valid(item["points"]):
                continue
            gt_rects.append(item["points"])
            if item.get("ignore", False):
                gt_dont_care.append(len(gt_rects) - 1)

        det_rects, det_dont_care = [], []
        for item in pred:
            if not _valid(item["points"]):
                continue
            det_rects.append(item["points"])
            if gt_dont_care:
                det_area = geo.polygon_area(item["points"])
                for idx in gt_dont_care:
                    inter = geo.intersection_area(gt_rects[idx],
                                                  item["points"])
                    prec = 0 if det_area == 0 else inter / det_area
                    if prec > self.tp:
                        det_dont_care.append(len(det_rects) - 1)
                        break

        recall = precision = hmean = 0.0
        recall_accum = precision_accum = 0.0
        pairs = []
        # the reference leaves these 1x1 matrices uninitialised
        # (np.empty) when there is no detection; zeros here
        recall_mat = np.zeros((1, 1))
        precision_mat = np.zeros((1, 1))

        if len(gt_rects) == 0:
            recall = 1.0
            precision = 0.0 if det_rects else 1.0

        if det_rects:
            n_gt, n_det = len(gt_rects), len(det_rects)
            recall_mat = np.zeros((n_gt, n_det))
            precision_mat = np.zeros((n_gt, n_det))
            for g in range(n_gt):
                g_area = geo.polygon_area(gt_rects[g])
                for d in range(n_det):
                    inter = geo.intersection_area(gt_rects[g], det_rects[d])
                    d_area = geo.polygon_area(det_rects[d])
                    recall_mat[g, d] = 0 if g_area == 0 else inter / g_area
                    precision_mat[g, d] = 0 if d_area == 0 else \
                        inter / d_area

            gt_mat = np.zeros(n_gt, np.int8)
            det_mat = np.zeros(n_det, np.int8)
            qualify = (recall_mat >= self.tr) & (precision_mat >= self.tp)

            def num_overlaps_gt(g):
                return sum(1 for d in range(n_det)
                           if d not in det_dont_care and recall_mat[g, d] > 0)

            def num_overlaps_det(d):
                return sum(1 for g in range(n_gt)
                           if g not in gt_dont_care and recall_mat[g, d] > 0)

            def center_distance(r1, r2):
                return float(np.linalg.norm(
                    np.mean(np.asarray(r1, float), axis=0)
                    - np.mean(np.asarray(r2, float), axis=0)))

            def diag(r):
                r = np.asarray(r, float)
                return float(np.hypot(r[:, 0].max() - r[:, 0].min(),
                                      r[:, 1].max() - r[:, 1].min()))

            # one-to-one (src/deteval.py:225-251)
            for g in range(n_gt):
                for d in range(n_det):
                    if (gt_mat[g] == 0 and det_mat[d] == 0
                            and g not in gt_dont_care
                            and d not in det_dont_care):
                        if (qualify[g].sum() == 1
                                and qualify[:, d].sum() == 1
                                and qualify[g, d]):
                            if (num_overlaps_gt(g) == 1
                                    and num_overlaps_det(d) == 1):
                                norm_dist = 2.0 * center_distance(
                                    gt_rects[g], det_rects[d]) / (
                                        diag(gt_rects[g])
                                        + diag(det_rects[d]))
                                if norm_dist < self.center_diff_thr:
                                    gt_mat[g] = det_mat[d] = 1
                                    recall_accum += self.mtype_oo_o
                                    precision_accum += self.mtype_oo_o
                                    pairs.append({"gt": g, "det": d,
                                                  "type": "OO"})

            # one-to-many: GT split across several dets (:253-285)
            for g in range(n_gt):
                if g in gt_dont_care:
                    continue
                many_sum = 0.0
                matches = []
                for d in range(n_det):
                    if (gt_mat[g] == 0 and det_mat[d] == 0
                            and d not in det_dont_care
                            and precision_mat[g, d] >= self.tp):
                        many_sum += recall_mat[g, d]
                        matches.append(d)
                if round(many_sum, 4) >= self.tr and matches:
                    if num_overlaps_gt(g) >= 2:
                        gt_mat[g] = 1
                        one = len(matches) == 1
                        recall_accum += (self.mtype_oo_o if one
                                         else self.mtype_om_o)
                        precision_accum += (self.mtype_oo_o if one else
                                            self.mtype_om_o * len(matches))
                        pairs.append({"gt": g, "det": matches,
                                      "type": "OO" if one else "OM"})
                        for d in matches:
                            det_mat[d] = 1

            # many-to-one: several GTs merged into one det (:288-318)
            for d in range(n_det):
                if d in det_dont_care:
                    continue
                many_sum = 0.0
                matches = []
                for g in range(n_gt):
                    if (gt_mat[g] == 0 and det_mat[d] == 0
                            and g not in gt_dont_care
                            and recall_mat[g, d] >= self.tr):
                        many_sum += precision_mat[g, d]
                        matches.append(g)
                if round(many_sum, 4) >= self.tp and matches:
                    if num_overlaps_det(d) >= 2:
                        det_mat[d] = 1
                        one = len(matches) == 1
                        recall_accum += (self.mtype_oo_o if one else
                                         self.mtype_om_m * len(matches))
                        precision_accum += (self.mtype_oo_o if one
                                            else self.mtype_om_m)
                        pairs.append({"gt": matches, "det": d,
                                      "type": "OO" if one else "MO"})
                        for g in matches:
                            gt_mat[g] = 1

            num_gt_care = len(gt_rects) - len(gt_dont_care)
            if num_gt_care == 0:
                recall = 1.0
                precision = 0.0 if det_rects else 1.0
            else:
                recall = recall_accum / num_gt_care
                num_det_care = len(det_rects) - len(det_dont_care)
                precision = 0.0 if num_det_care == 0 else \
                    precision_accum / num_det_care
            hmean = 0 if precision + recall == 0 else \
                2.0 * precision * recall / (precision + recall)

        num_gt_care = len(gt_rects) - len(gt_dont_care)
        num_det_care = len(det_rects) - len(det_dont_care)
        return {
            "precision": precision,
            "recall": recall,
            "hmean": hmean,
            "pairs": pairs,
            "recallMat": [] if len(det_rects) > 100 else recall_mat.tolist(),
            "precisionMat":
                [] if len(det_rects) > 100 else precision_mat.tolist(),
            "gtPolPoints": gt_rects,
            "detPolPoints": det_rects,
            "gtCare": num_gt_care,
            "detCare": num_det_care,
            "gtDontCare": gt_dont_care,
            "detDontCare": det_dont_care,
            "recallAccum": recall_accum,
            "precisionAccum": precision_accum,
        }

    def combine_results(self, results):
        num_gt = sum(r["gtCare"] for r in results)
        num_det = sum(r["detCare"] for r in results)
        recall_sum = sum(r["recallAccum"] for r in results)
        precision_sum = sum(r["precisionAccum"] for r in results)
        recall = 0 if num_gt == 0 else recall_sum / num_gt
        precision = 0 if num_det == 0 else precision_sum / num_det
        hmean = 0 if recall + precision == 0 else \
            2 * recall * precision / (recall + precision)
        return {"precision": precision, "recall": recall, "hmean": hmean}
