"""Pixel-level segmentation metrics.

Port of ``fast_hist``, ``RunningScore`` (Overall/Mean Acc, Mean IoU, FreqW
Acc), ``cal_text_score`` and ``AverageMeter`` from
``db_text_minimal_tpu/metrics/pixel.py``. The
train and eval steps count their 2×2 histograms on the device
(``train.trainer.confusion_hist_2x2``); the running matrix is host numpy.
"""

from __future__ import annotations

import numpy as np


def fast_hist(label_true: np.ndarray, label_pred: np.ndarray,
              n_class: int) -> np.ndarray:
    """(n_class, n_class) counts of (true, predicted) label pairs."""
    mask = (label_true >= 0) & (label_true < n_class)
    hist = np.bincount(
        n_class * label_true[mask].astype(int) + label_pred[mask],
        minlength=n_class ** 2).reshape(n_class, n_class)
    return hist


class RunningScore:
    """Running confusion matrix with accuracy and IoU scores."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.confusion_matrix = np.zeros((n_classes, n_classes))

    def update(self, label_trues, label_preds):
        for lt, lp in zip(label_trues, label_preds):
            self.confusion_matrix += fast_hist(
                np.asarray(lt).flatten(), np.asarray(lp).flatten(),
                self.n_classes)

    def get_scores(self):
        hist = self.confusion_matrix
        acc = np.diag(hist).sum() / (hist.sum() + 0.0001)
        acc_cls = np.diag(hist) / (hist.sum(axis=1) + 0.0001)
        acc_cls = np.nanmean(acc_cls)
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) -
                              np.diag(hist) + 0.0001)
        mean_iu = np.nanmean(iu)
        freq = hist.sum(axis=1) / (hist.sum() + 0.0001)
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
        cls_iu = dict(zip(range(self.n_classes), iu))
        return {
            "Overall Acc": acc,
            "Mean Acc": acc_cls,
            "FreqW Acc": fwavacc,
            "Mean IoU": mean_iu,
        }, cls_iu

    def reset(self):
        self.confusion_matrix = np.zeros((self.n_classes, self.n_classes))


def cal_text_score(texts, gt_texts, training_masks, running_metric_text,
                   thresh: float = 0.5):
    """Threshold the predicted prob map under the supervision mask, update
    the running confusion matrix with it against the GT text map and
    return its scores. Inputs are (N, H, W) arrays or CPU tensors."""
    training_masks = np.asarray(training_masks)
    pred_text = np.asarray(texts) * training_masks
    pred_text = (pred_text > thresh).astype(np.int32)
    gt_text = (np.asarray(gt_texts) * training_masks).astype(np.int32)
    running_metric_text.update(gt_text, pred_text)
    score_text, _ = running_metric_text.get_scores()
    return score_text


class AverageMeter:
    """Running value, sum, count and average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
        return self
