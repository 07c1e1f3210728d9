"""Backbone pretraining on a pretext task, exported as a torchvision ``.pth``.

Port of ``db_text_minimal_tpu/train/backbone_pretrain.py``. The reference
warm-starts its backbone from torchvision's ImageNet resnet18; without
ImageNet weights, the detector's own ResNet is pretrained on synthetic
scenes and written with torchvision's keys, which the ``Trainer`` reads
through ``model.pretrained_backbone_path``:

- the dense pretext (``BackboneDense``, ``pretrain_backbone_dense``): each
  8x8 cell of a 128x128 crop is text (word boxes cover > 35 % of it) or not
  (< 5 %; cells between are masked out), predicted from c3 with c4
  upsampled beside it by a 1x1 conv, under a class-balanced BCE;
- the classification pretext (``BackboneClassifier``,
  ``pretrain_backbone``): a crop is text (> 8 % covered) or not (< 1 %),
  in balanced batches, from the pooled c5.

The samplers draw from ``np.random.RandomState(seed)`` in the JAX order, so
they give the JAX package's crops exactly. Adam is ``torch.optim.Adam``
(betas 0.9/0.999, eps 1e-8, as ``train/trainer.make_optimizer``), its rate
set every step: optax's ``cosine_decay_schedule`` for the dense pretext,
constant for the other. Runs on ``device``, CUDA by default, in float32.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..lr_schedules import cosine_decay_schedule
from ..models.layers import init_weights, resize_nearest
from ..models.resnet import BACKBONE_OUT_CHANNELS, BACKBONES
from ..utils import CAFFE_MEAN, resolve_device
from .trainer import set_lr


def _init_linear(layer: nn.Module, generator: torch.Generator) -> None:
    """flax's default ``Dense``/``Conv`` init in shape: a zero-mean normal
    of variance 1/fan_in, zero bias."""
    fan_in = layer.weight[0].numel()
    with torch.no_grad():
        layer.weight.normal_(0.0, math.sqrt(1.0 / fan_in),
                             generator=generator)
        layer.bias.zero_()


class BackboneClassifier(nn.Module):
    """Backbone -> c5 averaged over H and W -> linear logits. NHWC float32
    images in; the backbone's state_dict keys are the detector's."""

    def __init__(self, backbone_name: str = "resnet18",
                 num_classes: int = 2):
        super().__init__()
        self.backbone = BACKBONES[backbone_name]()
        self.fc = nn.Linear(BACKBONE_OUT_CHANNELS[backbone_name][3],
                            num_classes)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_weights(self.backbone, generator)
        _init_linear(self.fc, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c5 = self.backbone(x.permute(0, 3, 1, 2))[3]
        return self.fc(c5.mean(dim=(2, 3)))


class BackboneDense(nn.Module):
    """Backbone -> c3 (stride 8) beside c4 upsampled to it (nearest) -> a
    1x1 conv -> one text logit a cell, (N, H/8, W/8)."""

    def __init__(self, backbone_name: str = "resnet18"):
        super().__init__()
        self.backbone = BACKBONES[backbone_name]()
        widths = BACKBONE_OUT_CHANNELS[backbone_name]
        self.cell_head = nn.Conv2d(widths[1] + widths[2], 1, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_weights(self.backbone, generator)
        _init_linear(self.cell_head, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, c3, c4, _ = self.backbone(x.permute(0, 3, 1, 2))
        h = torch.cat([c3, resize_nearest(c4, c3.shape[2:])], dim=1)
        return self.cell_head(h)[:, 0]


def sample_patches_dense(images: list, bboxes: list,
                         rng: np.random.RandomState, n: int,
                         patch: int = 128, cell: int = 8):
    """``n`` random crops with per-cell labels at stride ``cell``: 1 where
    the word boxes cover > 35 % of the cell, 0 where < 5 %, weight 0 in
    between. Returns (crops minus the Caffe means, labels, weights)."""
    g = patch // cell
    xs = np.empty((n, patch, patch, 3), np.float32)
    ys = np.zeros((n, g, g), np.float32)
    ws = np.zeros((n, g, g), np.float32)
    for count in range(n):
        i = rng.randint(len(images))
        img = images[i]
        H, W = img.shape[:2]
        x0 = rng.randint(0, W - patch)
        y0 = rng.randint(0, H - patch)
        cover = np.zeros((patch, patch), np.float32)
        for bx0, by0, bx1, by1 in bboxes[i]:
            ix0 = int(np.clip(bx0 - x0, 0, patch))
            ix1 = int(np.clip(bx1 - x0, 0, patch))
            iy0 = int(np.clip(by0 - y0, 0, patch))
            iy1 = int(np.clip(by1 - y0, 0, patch))
            cover[iy0:iy1, ix0:ix1] = 1.0
        frac = cover.reshape(g, cell, g, cell).mean(axis=(1, 3))
        ys[count] = (frac > 0.35).astype(np.float32)
        ws[count] = ((frac > 0.35) | (frac < 0.05)).astype(np.float32)
        xs[count] = img[y0:y0 + patch, x0:x0 + patch].astype(np.float32)
    return xs - np.asarray(CAFFE_MEAN, np.float32), ys, ws


def sample_patches(images: list, bboxes: list, rng: np.random.RandomState,
                   n: int, patch: int = 128):
    """``n`` random crops labelled text (1, > 8 % covered by word boxes)
    or not (0, < 1 %), alternating, ambiguous crops drawn again. Returns
    (crops minus the Caffe means, int32 labels)."""
    xs = np.empty((n, patch, patch, 3), np.float32)
    ys = np.empty((n,), np.int32)
    count = 0
    while count < n:
        i = rng.randint(len(images))
        img = images[i]
        H, W = img.shape[:2]
        x0 = rng.randint(0, W - patch)
        y0 = rng.randint(0, H - patch)
        cover = 0.0
        for bx0, by0, bx1, by1 in bboxes[i]:
            iw = min(bx1, x0 + patch) - max(bx0, x0)
            ih = min(by1, y0 + patch) - max(by0, y0)
            if iw > 0 and ih > 0:
                cover += iw * ih
        frac = cover / (patch * patch)
        label = 1 if frac > 0.08 else (0 if frac < 0.01 else -1)
        if label < 0:      # ambiguous crop: draw again
            continue
        if label != count % 2:   # alternate the classes
            continue
        xs[count] = img[y0:y0 + patch, x0:x0 + patch].astype(np.float32)
        ys[count] = label
        count += 1
    return xs - np.asarray(CAFFE_MEAN, np.float32), ys


def load_scene_bboxes(train_dir: str, gt_dir: str, limit: int | None = None):
    """The RGB images of a TotalText-format set and each one's word boxes,
    (K, 4) arrays of [x0, y0, x1, y1]."""
    import cv2

    from ..data.parsers import load_totaltext

    fps, anns = load_totaltext(train_dir, gt_dir)
    if limit:
        fps, anns = fps[:limit], anns[:limit]
    images, bboxes = [], []
    for fp, ann in zip(fps, anns):
        img = cv2.imread(fp)[:, :, ::-1]
        images.append(np.ascontiguousarray(img))
        bb = []
        for item in ann:
            poly = np.asarray(item["poly"], np.float64)
            bb.append([poly[:, 0].min(), poly[:, 1].min(),
                       poly[:, 0].max(), poly[:, 1].max()])
        bboxes.append(np.asarray(bb) if bb else np.zeros((0, 4)))
    return images, bboxes


def dense_loss(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """The dense pretext's class-balanced BCE (positive and negative cells
    weighted 0.5 each over their counts + 1) and its cell accuracy over
    the weighted cells."""
    pos = (y * w).sum() + 1.0
    neg = ((1 - y) * w).sum() + 1.0
    cw = w * (y * (0.5 / pos) + (1 - y) * (0.5 / neg))
    bce = F.binary_cross_entropy_with_logits(logits, y, reduction="none")
    acc = (((logits > 0) == (y > 0.5)) * w).sum() / w.sum().clamp_min(1.0)
    return (bce * cw).sum(), acc


def classify_loss(logits: torch.Tensor, y: torch.Tensor):
    """Softmax cross entropy with integer labels, and the accuracy."""
    y = y.long()
    return (F.cross_entropy(logits, y),
            (logits.argmax(-1) == y).float().mean())


def build_step(model: nn.Module, loss_fn, device):
    """``step(lr, x, *targets) -> (loss, acc)`` tensors on ``device``: a
    train-mode forward of numpy batches, ``loss_fn(logits, *targets)``,
    the backward and one Adam step at ``lr``. Returns it with its
    optimizer."""
    optimizer = torch.optim.Adam(
        [{"params": list(model.parameters()), "lr_mult": 1.0}], lr=0.0,
        betas=(0.9, 0.999), eps=1e-8)

    def step(lr: float, x: np.ndarray, *targets):
        model.train()
        set_lr(optimizer, lr)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = loss_fn(model(torch.from_numpy(x).to(device)),
                            *(torch.from_numpy(t).to(device)
                              for t in targets))
        loss.backward()
        optimizer.step()
        return loss.detach(), acc.detach()

    return step, optimizer


def save_backbone_pth(path: str, backbone: nn.Module) -> None:
    """``torch.save`` the backbone's state_dict, torchvision's keys (a
    deformable conv's offset branch left out, as the JAX export leaves
    it)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu().clone()
                for k, v in backbone.state_dict().items()
                if "offset_conv" not in k.split(".")}, path)


def _pretrain(model: nn.Module, sample, loss_fn, schedule, steps: int,
              seed: int, out_path: str, device, log, what: str,
              metric: str) -> float:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    step, _ = build_step(model, loss_fn, device)
    acc = torch.zeros(())
    for i in range(steps):
        _, acc = step(schedule(i), *sample())
        if (i + 1) % 50 == 0:
            log(f"{what} step {i + 1}/{steps} {metric}={float(acc):.3f}")
    save_backbone_pth(out_path, model.backbone)
    return float(acc)


def pretrain_backbone_dense(train_dir: str, gt_dir: str, out_path: str,
                            backbone: str = "resnet18", steps: int = 1000,
                            batch_size: int = 64, lr: float = 2e-3,
                            seed: int = 0, limit_images: int | None = 512,
                            log=print, device="cuda") -> dict:
    """The dense pretext for ``steps`` steps of ``batch_size`` crops at
    optax's cosine decay from ``lr``, then the ``.pth``. Returns
    ``{"cell_accuracy", "steps", "path"}``."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    images, bboxes = load_scene_bboxes(train_dir, gt_dir, limit_images)
    acc = _pretrain(
        BackboneDense(backbone),
        lambda: sample_patches_dense(images, bboxes, rng, batch_size),
        dense_loss, cosine_decay_schedule(lr, steps), steps, seed,
        out_path, device, log, "dense pretrain", "cell_acc")
    return {"cell_accuracy": acc, "steps": steps, "path": out_path}


def pretrain_backbone(train_dir: str, gt_dir: str, out_path: str,
                      backbone: str = "resnet18", steps: int = 300,
                      batch_size: int = 64, lr: float = 1e-3,
                      seed: int = 0, limit_images: int | None = 256,
                      log=print, device="cuda") -> dict:
    """The classification pretext for ``steps`` steps at ``lr``, then the
    ``.pth``. Returns ``{"accuracy", "steps", "path"}``."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    images, bboxes = load_scene_bboxes(train_dir, gt_dir, limit_images)
    acc = _pretrain(
        BackboneClassifier(backbone),
        lambda: sample_patches(images, bboxes, rng, batch_size),
        classify_loss, lambda _: lr, steps, seed, out_path, device, log,
        "pretrain", "acc")
    return {"accuracy": acc, "steps": steps, "path": out_path}
