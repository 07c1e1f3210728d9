"""QuadMetric: from postprocess output and GT annotations to per-image IoU
evaluation and epoch-level P/R/F.

Port of ``db_text_minimal_tpu/metrics/quad.py``; batches carry plain numpy
annotations.
"""

from __future__ import annotations

import numpy as np

from .iou import DetectionIoUEvaluator
from .pixel import AverageMeter


class QuadMetric:
    """Box metrics of a batch against its annotations."""

    def __init__(self, evaluator=None):
        self.evaluator = evaluator or DetectionIoUEvaluator()

    def measure(self, batch, output, is_output_polygon=False,
                box_thresh=0.6):
        """``batch``: dict with ``anns`` (list per image of polygons) and
        ``ignore_tags`` (list per image of bools).
        ``output``: (boxes_batch, scores_batch) from a representer.
        Returns one result dict per image."""
        boxes_batch, scores_batch = output
        results = []
        for image_idx in range(len(batch["anns"])):
            gt = [{"points": [tuple(p) for p in np.asarray(poly).tolist()],
                   "ignore": bool(ignore)}
                  for poly, ignore in zip(batch["anns"][image_idx],
                                          batch["ignore_tags"][image_idx])]
            pred = [{"points": np.asarray(box).tolist(), "ignore": False}
                    for box in boxes_batch[image_idx]]
            results.append(self.evaluator.evaluate_image(gt, pred))
        return results

    def validate_measure(self, batch, output, is_output_polygon=False,
                         box_thresh=0.6):
        return self.measure(batch, output, is_output_polygon, box_thresh)

    def gather_measure(self, raw_metrics):
        """Epoch-level precision, recall and F from per-image results."""
        raw_metrics = [m for batch_metrics in raw_metrics
                       for m in batch_metrics]
        result = self.evaluator.combine_results(raw_metrics)
        precision = AverageMeter()
        recall = AverageMeter()
        fmeasure = AverageMeter()
        precision.update(result["precision"], n=len(raw_metrics))
        recall.update(result["recall"], n=len(raw_metrics))
        fmeasure.update(
            2 * precision.val * recall.val
            / (precision.val + recall.val + 1e-8))
        return {"precision": precision, "recall": recall,
                "fmeasure": fmeasure}
