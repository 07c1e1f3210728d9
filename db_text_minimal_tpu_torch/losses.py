"""DB losses: OHEM-balanced BCE + dice + masked L1.

Port of ``db_text_minimal_tpu/losses.py``. ``reduction='none'`` is true
per-pixel OHEM: the top ``negative_ratio × #positives`` negative pixels by
loss, summed by a 34-round bisection for the k-th largest value
(``_topk_sum``), not a sort. ``reduction='mean'`` reproduces the reference's
degenerate form, the top-k of a constant map.

Every count and bracket stays a 0-d tensor on the maps' device and each
bisection round steps with ``torch.where``, so a train step reads nothing
back to the host. All maps are (N, H, W); ``preds`` are NHWC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _bce(pred: torch.Tensor, gt: torch.Tensor,
         eps: float = 1e-7) -> torch.Tensor:
    """Per-pixel binary cross entropy on probabilities clipped to
    [eps, 1 − eps]."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))


def _topk_sum(values: torch.Tensor, k: torch.Tensor,
              iters: int = 34) -> torch.Tensor:
    """Sum of the ``k`` largest entries of a non-negative map, ``k`` a 0-d
    f32 tensor. Bisects for the k-th largest value t on the bracket
    ±max(max, 1) with ``count(values > mid) >= k``, then takes the
    tie-corrected sum Σ values·[values > t] + t·(k − count(values > t)),
    ties at t counted fractionally. The gradient is 1 on the selected
    entries; t is detached."""
    sg = values.detach()
    hi = torch.clamp(sg.max(), min=1.0)
    lo = -1.0 * hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        keep_lo = (sg > mid).sum() >= k
        lo, hi = torch.where(keep_lo, mid, lo), torch.where(keep_lo, hi, mid)
    above = (sg > lo).to(values.dtype)
    cnt = above.sum()
    return (values * above).sum() + lo * (k - cnt)


def ohem_balance_bce(pred: torch.Tensor, gt: torch.Tensor,
                     mask: torch.Tensor, negative_ratio: float = 3.0,
                     eps: float = 1e-6,
                     reduction: str = "mean") -> torch.Tensor:
    """``reduction='none'``: true per-pixel OHEM; ``'mean'``: the reference's
    degenerate form."""
    positive = gt * mask
    negative = (1.0 - gt) * mask
    no_positive = positive.sum()
    no_negative = torch.minimum(no_positive * negative_ratio, negative.sum())
    if reduction == "mean":
        loss = _bce(pred, gt).mean()
        positive_sum = loss * no_positive
        negative_sum = loss * no_negative
    else:
        loss = _bce(pred, gt)
        positive_sum = (loss * positive).sum()
        negative_sum = _topk_sum(loss * negative, no_negative)
    return (positive_sum + negative_sum) / (no_positive + no_negative + eps)


def dice_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """1 − 2·∩/∪ under the supervision mask."""
    intersection = (pred * gt * mask).sum()
    union = (pred * mask).sum() + (gt * mask).sum() + eps
    return 1.0 - 2.0 * intersection / union


def masked_l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Σ|pred − gt|·mask / (Σmask + eps)."""
    return (torch.abs(pred - gt) * mask).sum() / (mask.sum() + eps)


class DBLossOutput(NamedTuple):
    """The five train-mode losses, in the reference's order."""
    prob_loss: torch.Tensor
    threshold_loss: torch.Tensor
    binary_loss: torch.Tensor
    prob_threshold_loss: torch.Tensor
    total_loss: torch.Tensor


def db_loss(preds: torch.Tensor, prob_gt: torch.Tensor,
            supervision_mask: torch.Tensor, thresh_gt: torch.Tensor,
            text_area_mask: torch.Tensor, alpha: float = 1.0,
            beta: float = 10.0, negative_ratio: float = 3.0,
            eps: float = 1e-6, reduction: str = "mean") -> DBLossOutput:
    """Train branch: ``preds`` NHWC with 3 channels (P, T, B̂);
    total = alpha·dice(B̂) + ohem_bce(P) + beta·l1(T)."""
    prob_loss = ohem_balance_bce(preds[..., 0], prob_gt, supervision_mask,
                                 negative_ratio, eps, reduction)
    threshold_loss = masked_l1_loss(preds[..., 1], thresh_gt, text_area_mask,
                                    eps)
    prob_threshold_loss = prob_loss + beta * threshold_loss
    binary_loss = dice_loss(preds[..., 2], prob_gt, supervision_mask, eps)
    total_loss = alpha * binary_loss + prob_threshold_loss
    return DBLossOutput(prob_loss, threshold_loss, binary_loss,
                        prob_threshold_loss, total_loss)


def db_loss_eval(preds: torch.Tensor, prob_gt: torch.Tensor,
                 supervision_mask: torch.Tensor, thresh_gt: torch.Tensor,
                 text_area_mask: torch.Tensor, beta: float = 10.0,
                 negative_ratio: float = 3.0, eps: float = 1e-6,
                 reduction: str = "mean") -> torch.Tensor:
    """Eval branch (2-channel preds): prob_loss + beta·threshold_loss."""
    prob_loss = ohem_balance_bce(preds[..., 0], prob_gt, supervision_mask,
                                 negative_ratio, eps, reduction)
    threshold_loss = masked_l1_loss(preds[..., 1], thresh_gt, text_area_mask,
                                    eps)
    return prob_loss + beta * threshold_loss
