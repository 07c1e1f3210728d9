"""Learning-rate schedules.

Port of ``db_text_minimal_tpu/lr_schedules.py``: ``warmup_poly_lr``, a pure
``step -> lr`` schedule (the reference's ``WarmupPolyLR``), and
``ReduceLROnPlateau``, host-side state stepped once per epoch on the test
loss whose ``scale`` multiplies the base learning rate, and
``cosine_decay_schedule``, optax's (the backbone pretraining's). All are
numpy: the trainers evaluate them on the host and set the optimizer's rate
per step.
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


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax's ``cosine_decay_schedule`` (optax 0.2.6,
    ``schedules/_schedule.py``), in float32 as optax computes it:
    ``init · ((1 − alpha) · ½(1 + cos(π · min(t, N) / N)) + alpha)``."""
    f32 = np.float32

    def schedule(count):
        count = f32(min(count, decay_steps))
        # the f32 argument's cosine rounded to f32: XLA's within an ulp
        cos = f32(np.cos(np.float64(f32(np.pi) * count / f32(decay_steps))))
        cosine = f32(0.5) * (f32(1) + cos)
        return float(f32(init_value) * ((f32(1) - f32(alpha)) * cosine
                                        + f32(alpha)))

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
