"""Evaluation metrics: pixel-level running scores, the IoU-Pascal and
DetEval box protocols and the QuadMetric batch wrapper."""

from .deteval import DetectionDetEvalEvaluator
from .iou import DetectionIoUEvaluator, polygon_iou
from .pixel import AverageMeter, RunningScore, cal_text_score, fast_hist
from .quad import QuadMetric

__all__ = ["DetectionDetEvalEvaluator", "DetectionIoUEvaluator",
           "polygon_iou", "AverageMeter", "RunningScore", "cal_text_score",
           "fast_hist", "QuadMetric"]
