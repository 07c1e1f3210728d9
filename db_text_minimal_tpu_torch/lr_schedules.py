"""Learning-rate schedules.

Port of ``db_text_minimal_tpu/lr_schedules.py``: ``warmup_poly_lr``, a pure
``step -> lr`` schedule (the reference's ``WarmupPolyLR``), and
``ReduceLROnPlateau``, host-side state stepped once per epoch on the test
loss whose ``scale`` multiplies the base learning rate. Both are numpy: the
trainer evaluates them on the host and sets the optimizer's rate per step.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def warmup_poly_lr(base_lr: float, target_lr: float = 0.0,
                   max_iters: int = 0, power: float = 0.9,
                   warmup_factor: float = 1.0 / 3, warmup_iters: int = 500,
                   warmup_method: str = "linear"):
    """Linear or constant warmup, then polynomial decay ``(1 − T/N)^power``.
    Keeps the reference's quirk that ``max_iters`` defaults to 0, so past
    warmup the decay base goes negative; the factor is clamped to 0 rather
    than giving NaNs."""
    if warmup_method not in ("constant", "linear"):
        raise ValueError(
            "Only 'constant' or 'linear' warmup_method accepted got {}".format(
                warmup_method))

    def schedule(step):
        step = np.float32(step)
        if warmup_method == "constant":
            wf = warmup_factor
        else:
            alpha = step / max(warmup_iters, 1)
            wf = warmup_factor * (1 - alpha) + alpha
        warmup_lr = target_lr + (base_lr - target_lr) * wf

        n = max(max_iters - warmup_iters, 1)
        t = step - warmup_iters
        factor = np.clip(1.0 - t / n, 0.0, 1.0) ** power
        decay_lr = target_lr + (base_lr - target_lr) * factor
        return np.where(step < warmup_iters, warmup_lr, decay_lr)

    return schedule


@dataclass
class ReduceLROnPlateau:
    """``ReduceLROnPlateau(mode='min', factor, patience)`` as a multiplier:
    call ``step(metric)`` once per epoch and read ``scale``, the factor on
    the base learning rate."""

    factor: float = 0.2
    patience: int = 4
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = field(default=np.inf)
    num_bad_epochs: int = 0
    scale: float = 1.0

    def step(self, metric: float) -> float:
        metric = float(metric)
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.scale = max(self.scale * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.scale
