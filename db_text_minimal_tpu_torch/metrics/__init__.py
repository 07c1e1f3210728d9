"""Evaluation metrics: pixel-level running scores, the IoU-Pascal box
protocol and the QuadMetric batch wrapper."""

from .iou import DetectionIoUEvaluator, polygon_iou
from .pixel import AverageMeter, RunningScore, fast_hist
from .quad import QuadMetric

__all__ = ["DetectionIoUEvaluator", "polygon_iou", "AverageMeter",
           "RunningScore", "fast_hist", "QuadMetric"]
