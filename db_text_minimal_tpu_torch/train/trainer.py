"""Trainer: the train and eval steps and the epoch loop.

Port of ``db_text_minimal_tpu/train/trainer.py`` for one card:

- a train step is the forward in train mode (P, T, B̂; B̂ through kernel K2),
  the DB loss, the backward (K2's backward kernel), an Adam step at the
  learning rate of the schedule, and the 2×2 confusion histogram counted on
  the device;
- the eval step runs the model in eval mode, the eval loss and the
  histogram; the epoch's box P/R/F come from ``QuadMetric`` over the
  representer of ``metric.is_output_polygon``: polygon mode (the default)
  on the host ``SegDetectorRepresenter`` over a host copy of the preds, as
  the JAX trainer does, and rect mode on ``DeviceBoxRepresenter`` (kernels
  K3–K6) unless ``metric.device_boxes`` or ``device_boxes_in_train`` is
  off;
- the three-checkpoint policy and the warmup-poly (per step) or
  reduce-on-plateau (per epoch) learning rate;
- with a ``tb_writer`` (a TensorBoard ``SummaryWriter``), the JAX
  trainer's scalars under its tags and steps and its image grids
  (``utils/visualize.visualize_tfb``) at its points;
- in a distributed run (``parallel``: a process group joined) the model
  is held in ``DistributedDataParallel`` (``TrainState.ddp``), its batch
  norms and the loss over the global batch, and only process 0 writes
  checkpoints.

Losses and histograms stay on the device between log points: nothing is
read back per step. Scalars are logged every ``hps.log_iter`` steps and kept
in ``Trainer.loss_log``. The model computes in ``compute_dtype(cfg,
device)``: bfloat16 on CUDA under ``parallel.compute_dtype: bfloat16`` (the
default), as the JAX trainer on its accelerator, with parameters, the loss
and Adam in float32; otherwise, and always on the CPU, float32 with TF32
off for cuDNN and matmul, the parity configuration (the ``Trainer``
constructor sets both flags for the process). The rest of the JAX
``parallel`` section (the mesh) is ignored: the processes of a
distributed run are the data axis.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import losses as L
from .. import parallel
from ..config import ConfigNode
from ..lr_schedules import ReduceLROnPlateau, warmup_poly_lr
from ..metrics import QuadMetric, RunningScore
from ..models import DBTextModel
from ..models.prune import widths_to_model_kwargs
from ..postprocess import DeviceBoxRepresenter, SegDetectorRepresenter
from ..utils import (CAFFE_MEAN, StepTimer, resolve_device, setup_determinism,
                     setup_logger)
from ..utils.visualize import visualize_tfb
from .checkpoints import CheckpointPolicy, load_params_any, restore_checkpoint

ARRAY_KEYS = ("img", "prob_map", "supervision_mask", "thresh_map",
              "text_area_map")
# the JAX trainer's TensorBoard tags of the DBLossOutput fields
TB_LOSS_TAGS = (("TRAIN/LOSS/total_loss", "total_loss"),
                ("TRAIN/LOSS/loss", "prob_threshold_loss"),
                ("TRAIN/LOSS/prob_loss", "prob_loss"),
                ("TRAIN/LOSS/threshold_loss", "threshold_loss"),
                ("TRAIN/LOSS/binary_loss", "binary_loss"))


def array_batch(batch: dict) -> dict:
    """The array entries of a loader batch."""
    return {k: batch[k] for k in ARRAY_KEYS if k in batch}


def to_device(batch: dict, device: torch.device) -> dict:
    """The array entries of a loader batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in array_batch(batch).items()}


def _unpack_bits(v: torch.Tensor) -> torch.Tensor:
    """uint8 (..., W/8) -> (..., W) of 0/1, the first pixel in the most
    significant bit (``np.packbits``' order)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=v.device)
    bits = (v.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(v.shape[:-1] + (v.shape[-1] * 8,))


def device_preprocess(batch: dict) -> dict:
    """The device's part of preprocessing, for tensors already on it: a
    uint8 image becomes float32 minus the Caffe means (RGB order, the
    reference's quirk), bit-packed binary maps (8 pixels a byte, as wide as
    the image over 8) are unpacked, and every map becomes float32. Float32
    batches pass through."""
    img = batch["img"]
    if img.dtype == torch.uint8:
        # an asynchronous copy: a blocking one would wait for the stream,
        # and so for the previous step, in every step
        mean = torch.tensor(CAFFE_MEAN, dtype=torch.float32)
        img = img.float() - mean.to(img.device, non_blocking=True)
    width = img.shape[-2]
    out = {"img": img}
    for key in ("prob_map", "supervision_mask", "thresh_map",
                "text_area_map"):
        if key in batch:
            v = batch[key]
            if v.dtype == torch.uint8 and v.shape[-1] * 8 == width:
                v = _unpack_bits(v)
            out[key] = v.float()
    return out


@dataclass
class TrainState:
    """The model, its optimizer and the count of steps taken; in a
    distributed run ``ddp``, the model in ``DistributedDataParallel``,
    which the train step runs."""
    model: DBTextModel
    optimizer: torch.optim.Optimizer
    step: int = 0
    ddp: torch.nn.Module | None = None

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}


def compute_dtype(cfg, device: torch.device) -> torch.dtype:
    """The model's compute dtype, chosen as the JAX trainer chooses it
    (trainer.py:219-221) with CUDA in its accelerator's place: bfloat16 when
    ``parallel.compute_dtype`` is ``"bfloat16"`` and ``device`` is CUDA,
    float32 otherwise."""
    wanted = cfg.parallel.compute_dtype if cfg.parallel else None
    if wanted == "bfloat16" and torch.device(device).type == "cuda":
        return torch.bfloat16
    return torch.float32


class Amsgrad(torch.optim.Optimizer):
    """optax's ``scale_by_amsgrad`` (optax 0.2.6, ``_src/transform.py``
    320-373) behind ``add_decayed_weights`` (``transforms/_adding.py``
    60-70: g + wd · p), at the group's learning rate:

    - m ← β1·m + (1−β1)·g and v ← β2·v + (1−β2)·g²
      (``tree_utils/_tree_math.py`` 353-399);
    - m̂ = m/(1−β1ᵗ), v̂ = v/(1−β2ᵗ) (the same file, 401-411), each
      1−βᵗ in float32 as optax takes it (0.999ᵗ in float32 is 1.3e-5
      relative off its float64 value after one step);
    - v_max ← max(v_max, v̂), the bias-corrected moment (torch's
      ``Adam(amsgrad=True)`` keeps the raw one);
    - p ← p − lr · m̂/(√v_max + eps).

    The state of a parameter is ``step`` (an int), ``mu``, ``nu`` and
    ``nu_max``, saved and restored by ``state_dict``."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps,
                                  "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for key in ("mu", "nu", "nu_max"):
                        state[key] = torch.zeros_like(p)
                state["step"] += 1
                t = np.float32(state["step"])
                mu, nu, nu_max = state["mu"], state["nu"], state["nu_max"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).add_(g * g, alpha=1 - b2)
                bc1 = float(np.float32(1) - np.float32(b1) ** t)
                bc2 = float(np.float32(1) - np.float32(b2) ** t)
                torch.maximum(nu_max, nu / bc2, out=nu_max)
                p.sub_(group["lr"] * (mu / bc1)
                       / (nu_max.sqrt() + group["eps"]))
        return None


def make_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Optimizer:
    """Adam with betas (0.9, 0.999) and eps 1e-8, weight decay as L2 in the
    gradient (torch Adam's form and optax's ``add_decayed_weights``, not
    AdamW): ``torch.optim.Adam``, or with ``optimizer.amsgrad`` the
    ``Amsgrad`` above, optax's rule as the JAX trainer chains it
    (trainer.py:108-118). The learning rate is set before every step
    (``set_lr``) from the schedule. The parameters of a deformable conv's
    offset branch (``offset_conv``) form a group of their own whose rate
    is scaled by ``optimizer.dcn_offset_lr_mult`` (JAX's
    ``optax.masked(optax.scale(mult))``)."""
    mult = float(cfg.optimizer.dcn_offset_lr_mult or 1.0)
    offset, rest = [], []
    for name, param in model.named_parameters():
        (offset if "offset_conv" in name.split(".") else rest).append(param)
    groups = [{"params": rest, "lr_mult": 1.0}]
    if offset:
        groups.append({"params": offset, "lr_mult": mult})
    wd = float(cfg.optimizer.weight_decay or 0.0)
    if cfg.optimizer.amsgrad:
        return Amsgrad(groups, betas=(0.9, 0.999), eps=1e-8,
                       weight_decay=wd)
    return torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=wd)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]


def confusion_hist_2x2(pred_prob: torch.Tensor, gt: torch.Tensor,
                       mask: torch.Tensor, thresh: float) -> torch.Tensor:
    """2-class confusion histogram (gt rows, prediction columns) on the
    maps' device; both maps are multiplied by the mask before the
    threshold and the cast."""
    pred = ((pred_prob * mask) > thresh).to(torch.int32)
    gt_i = (gt * mask).to(torch.int32)
    counts = [((gt_i == i) & (pred == j)).sum() for i in (0, 1)
              for j in (0, 1)]
    return torch.stack(counts).to(torch.float32).reshape(2, 2)


def _loss_settings(cfg) -> dict:
    # optimizer.reduction: 'mean' is the reference's degenerate OHEM,
    # 'none' the per-pixel one
    return {"beta": float(cfg.optimizer.beta),
            "negative_ratio": float(cfg.optimizer.negative_ratio),
            "reduction": str(cfg.optimizer.reduction or "mean")}


def build_train_step(cfg):
    """``train_step(state, batch, lr) -> (state, DBLossOutput, hist,
    preds)`` for a batch of tensors on the model's device. It updates
    ``state`` in place; the gradients stay in the parameters' ``.grad``
    until the next step. With ``state.ddp`` in a group of more than one,
    the loss, the histogram and the preds returned are the global batch's
    (``parallel.gather_batch``)."""
    alpha = float(cfg.optimizer.alpha)
    settings = _loss_settings(cfg)
    score_thresh = float(cfg.metric.thred_text_score)

    def train_step(state: TrainState, batch: dict, lr: float):
        batch = device_preprocess(batch)
        model, optimizer = state.model, state.optimizer
        model.train()
        set_lr(optimizer, lr)
        optimizer.zero_grad(set_to_none=True)
        net = model if state.ddp is None else state.ddp
        preds = net(batch["img"])
        if state.ddp is not None and parallel.world_size() > 1:
            preds = parallel.gather_batch(preds)
            batch = {k: parallel.gather_batch(v) for k, v in batch.items()
                     if k != "img"}
        out = L.db_loss(preds, batch["prob_map"], batch["supervision_mask"],
                        batch["thresh_map"], batch["text_area_map"],
                        alpha=alpha, **settings)
        out.total_loss.backward()
        optimizer.step()
        preds = preds.detach()
        hist = confusion_hist_2x2(preds[..., 0], batch["prob_map"],
                                  batch["supervision_mask"], score_thresh)
        state.step += 1
        return state, L.DBLossOutput(*(v.detach() for v in out)), hist, preds

    return train_step


def build_eval_step(cfg):
    """``eval_step(state, batch) -> (preds, loss, hist)``, the model in
    eval mode."""
    settings = _loss_settings(cfg)
    score_thresh = float(cfg.metric.thred_text_score)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        batch = device_preprocess(batch)
        state.model.eval()
        preds = state.model(batch["img"])
        loss = L.db_loss_eval(preds, batch["prob_map"],
                              batch["supervision_mask"], batch["thresh_map"],
                              batch["text_area_map"], **settings)
        hist = confusion_hist_2x2(preds[..., 0], batch["prob_map"],
                                  batch["supervision_mask"], score_thresh)
        return preds, loss, hist

    return eval_step


class Trainer:
    """The epoch loop over ``train_loader`` and ``test_loader``, any
    iterables of batch dicts (``data.datasets.DataLoader`` batches). The
    device is ``cfg.meta.device``, CUDA by default; on a machine without a
    GPU the caller must set it to ``"cpu"``. ``tb_writer``: a TensorBoard
    ``SummaryWriter`` or None."""

    def __init__(self, cfg: ConfigNode, train_loader=None, test_loader=None,
                 tb_writer=None):
        self.cfg = cfg
        self.tb_writer = tb_writer
        self.device = resolve_device(cfg.meta.device or "cuda")
        self.compute_dtype = compute_dtype(cfg, self.device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.logger = setup_logger(
            log_file_path=os.path.join(cfg.meta.root_dir or ".",
                                       cfg.logging.logger_file)
            if cfg.logging and cfg.logging.logger_file else None)
        self.seed = int(cfg.trainer.seed if cfg.trainer else 42)
        setup_determinism(self.seed)
        self.train_loader = train_loader
        self.test_loader = test_loader
        self._train_step = build_train_step(cfg)
        self._eval_step = build_eval_step(cfg)

        self.base_lr = float(cfg.optimizer.lr)
        if cfg.model.finetune_cp_path:
            self.base_lr = float(cfg.optimizer.lr_finetune)
        self.lrs_mode = cfg.lrs.mode if cfg.lrs else "reduce"
        if self.lrs_mode == "poly":
            # lrs.max_iters=0 keeps the reference's quirk (decay to 0 right
            # after warmup); set it to the planned number of steps for a
            # real polynomial decay
            self.poly_schedule = warmup_poly_lr(
                self.base_lr, warmup_iters=int(cfg.lrs.warmup_iters),
                max_iters=int(cfg.lrs.max_iters or 0))
            self.plateau = None
        else:
            self.poly_schedule = None
            self.plateau = ReduceLROnPlateau(factor=float(cfg.lrs.factor),
                                             patience=int(cfg.lrs.patience))
        self.global_step = 0
        self.loss_log: list[dict] = []
        self.epoch_timing: dict = {}

    # ------------------------------------------------------------------
    def init_state(self) -> TrainState:
        """Seeded random weights, then the pretrained backbone and the
        finetune checkpoint where the config names files that exist; in a
        distributed run the model also in ``DistributedDataParallel``. A
        pruned model's widths (``cfg.model.widths``, the checkpoint's
        sidecar, set by ``cli.train`` and ``quality_bench``) give the
        narrow architecture. A deformable backbone loads a torchvision
        ``.pth`` without its offset branches, which stay at zero, as the
        JAX ``load_pretrained_backbone`` merge leaves them."""
        cfg = self.cfg
        model = DBTextModel(backbone_name=cfg.model.backbone or "resnet18",
                            neck_name=cfg.model.neck or "FPN",
                            head_name=cfg.model.head or "DBHead",
                            compute_dtype=self.compute_dtype,
                            **widths_to_model_kwargs(cfg.model.widths))
        model.reset_parameters(torch.Generator().manual_seed(self.seed))
        pb = cfg.model.pretrained_backbone_path
        if pb and os.path.exists(str(pb)):
            self.logger.info("Loading pretrained backbone: %s", pb)
            sd = torch.load(str(pb), map_location="cpu", weights_only=True)
            missing, unexpected = model.backbone.load_state_dict(
                {k: v for k, v in sd.items() if not k.startswith("fc.")},
                strict=False)
            bad = unexpected + [
                k for k in missing if not k.endswith("num_batches_tracked")
                and "offset_conv" not in k.split(".")]
            if bad:
                raise ValueError(f"{pb}: keys do not match the backbone: "
                                 f"{bad}")
        ft = cfg.model.finetune_cp_path
        root = cfg.meta.root_dir or "."
        if ft and os.path.exists(os.path.join(root, str(ft))):
            path = os.path.join(root, str(ft))
            self.logger.info("Loading finetune checkpoint: %s", path)
            model.load_state_dict(load_params_any(path), strict=True)
        model.to(self.device)
        ddp = (parallel.wrap_model(model)
               if torch.distributed.is_initialized() else None)
        return TrainState(model, make_optimizer(cfg, model), ddp=ddp)

    def resume_state(self, checkpoint_path: str) -> TrainState:
        """The full training state of a checkpoint (weights, BN statistics,
        Adam moments, step). A ``.pth``, or a checkpoint of weights alone
        (``cli.prune`` writes one), holds no optimizer: it then starts
        afresh at step 0."""
        state = self.init_state()
        if checkpoint_path.endswith(".pth"):
            state.model.load_state_dict(load_params_any(checkpoint_path),
                                        strict=True)
        else:
            saved = restore_checkpoint(checkpoint_path)
            state.model.load_state_dict(saved["model"], strict=True)
            if "optimizer" in saved:
                state.optimizer.load_state_dict(saved["optimizer"])
                state.step = int(saved["step"])
        self.global_step = state.step
        return state

    def current_lr(self) -> float:
        if self.lrs_mode == "poly":
            return float(self.poly_schedule(self.global_step))
        return self.base_lr * self.plateau.scale

    def _representer(self):
        """The eval's representer and whether it takes the preds on their
        device: only rect mode runs on the device, as in the JAX trainer."""
        metric = self.cfg.metric
        on_device = (not metric.is_output_polygon
                     and bool(metric.device_boxes)
                     and bool(metric.device_boxes_in_train))
        cls = DeviceBoxRepresenter if on_device else SegDetectorRepresenter
        return cls(thresh=float(metric.thred_text_score),
                   box_thresh=float(metric.prob_threshold),
                   unclip_ratio=float(metric.unclip_ratio)), on_device

    # ------------------------------------------------------------------
    def train_epoch(self, state: TrainState, epoch: int):
        """One pass over ``train_loader``. Returns (state, mean total loss,
        RunningScore, (last batch, its preds)). ``epoch_timing`` then holds
        the epoch's wall seconds and the seconds the loop waited on the
        loader for a batch."""
        cfg = self.cfg
        dev = self.device
        running = RunningScore(int(cfg.hps.no_classes))
        timer = StepTimer(warmup=1)
        n_batches = 0
        last = (None, None)
        log_iter = int(cfg.hps.log_iter)
        loss_sum = torch.zeros((), device=dev)
        hist_sum = torch.zeros((2, 2), device=dev)
        pending: list = []   # (global_step, lr, loss_out) not yet read

        def flush(final: bool = False):
            nonlocal pending
            for gs, lr_v, lo in pending:
                row = {"step": gs, "lr": lr_v, **{
                    k: float(v) for k, v in lo._asdict().items()}}
                self.loss_log.append(row)
                self._scalars(gs, {
                    name: row[key] for name, key in TB_LOSS_TAGS} | {
                    "TRAIN/HPs/lr": lr_v})
            if pending:
                running.confusion_matrix = hist_sum.double().cpu().numpy()
                scores, _ = running.get_scores()
                self._scalars(pending[-1][0], {
                    "TRAIN/ACC_IOU/acc": scores["Mean Acc"],
                    "TRAIN/ACC_IOU/iou_shrink_map": scores["Mean IoU"]})
                if not final:
                    row = self.loss_log[-1]
                    self.logger.info(
                        "[%d-%d] - lr: %g - total_loss: %.5f - loss: %.5f "
                        "- acc: %.4f - iou: %.4f", epoch + 1, row["step"],
                        row["lr"], row["total_loss"],
                        row["prob_threshold_loss"], scores["Mean Acc"],
                        scores["Mean IoU"])
            pending = []

        t_epoch = time.perf_counter()
        wait = 0.0
        batches = iter(self.train_loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t0
            if batch is None:
                break
            lr = self.current_lr()
            self.global_step += 1
            n_batches += 1
            state, loss_out, hist, preds = self._train_step(
                state, to_device(batch, dev), lr)
            loss_sum += loss_out.total_loss
            hist_sum += hist
            timer.tick(batch["img"].shape[0])
            last = (batch, preds)
            pending.append((self.global_step, lr, loss_out))
            if self.global_step % log_iter == 0:
                flush()
        flush(final=True)
        train_loss = float(loss_sum)
        self.epoch_timing = {"wall_s": time.perf_counter() - t_epoch,
                             "loader_wait_s": wait}
        if timer.images_per_sec > 0:
            self.logger.info("throughput: %.1f img/s", timer.images_per_sec)
            self._scalars(self.global_step, {
                "TRAIN/HPs/images_per_sec": timer.images_per_sec})
        return state, train_loss / max(n_batches, 1), running, last

    # ------------------------------------------------------------------
    def eval_epoch(self, state: TrainState):
        """One pass over ``test_loader``. Returns (test loss, RunningScore,
        recall, precision, hmean)."""
        cfg = self.cfg
        dev = self.device
        representer, on_device = self._representer()
        is_poly = bool(cfg.metric.is_output_polygon)
        metric = QuadMetric()
        running = RunningScore(int(cfg.hps.no_classes))
        raw_metrics = []
        n = 0
        size = int(cfg.hps.img_size)
        loss_sum = torch.zeros((), device=dev)
        hist_sum = torch.zeros((2, 2), device=dev)
        # one random test batch gets the image grids (src/train.py:249-257)
        visualize_index = (np.random.randint(len(self.test_loader))
                           if self.tb_writer is not None
                           and len(self.test_loader) else -1)

        def finish(batch, preds):
            """Boxes and metrics of a batch, on the host while the device
            runs the next batch."""
            shape = {"shape": [(size, size)] * preds.shape[0]}
            boxes, scores = representer(
                shape, preds if on_device else preds.cpu().numpy(),
                is_output_polygon=is_poly)
            raw_metrics.append(metric.validate_measure(batch,
                                                       (boxes, scores)))

        pending = None
        for batch in self.test_loader:
            preds, loss, hist = self._eval_step(state, to_device(batch, dev))
            loss_sum += loss
            hist_sum += hist
            if n == visualize_index:
                self._grids(batch, preds, "TEST")
            n += 1
            if pending is not None:
                finish(*pending)
            pending = (batch, preds)
        if pending is not None:
            finish(*pending)
        running.confusion_matrix += hist_sum.double().cpu().numpy()
        metrics = metric.gather_measure(raw_metrics)
        test_loss = float(loss_sum) / max(n, 1)
        return (test_loss, running, metrics["recall"].avg,
                metrics["precision"].avg, metrics["fmeasure"].avg)

    # ------------------------------------------------------------------
    def fit(self, state: TrainState | None = None,
            no_epochs: int | None = None):
        """Train and evaluate for ``no_epochs`` (default ``hps.no_epochs``),
        saving the policy's checkpoints. Returns (state, history)."""
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        epochs = no_epochs if no_epochs is not None else int(
            cfg.hps.no_epochs)
        # one writer of the checkpoints in a distributed run
        policy = CheckpointPolicy(cfg.meta.root_dir or ".",
                                  cfg.model.best_cp_path,
                                  cfg.model.last_cp_path,
                                  cfg.model.best_hmean_cp_path,
                                  widths=cfg.model.widths) \
            if parallel.rank() == 0 else None
        history = []
        for epoch in range(epochs):
            state, train_loss, _, last = self.train_epoch(state, epoch)
            self.logger.info("Train loss: %.5f", train_loss)
            if last[0] is not None:
                # per-epoch image grids (src/train.py:215-220)
                self._grids(*last, "TRAIN")
            test_loss, _, recall, precision, hmean = self.eval_epoch(state)
            self.logger.info(
                "TEST/Recall: %.4f - TEST/Precision: %.4f - TEST/HMean: %.4f",
                recall, precision, hmean)
            self.logger.info("[%d] - test_loss: %.5f", self.global_step,
                             test_loss)
            self._scalars(self.global_step, {
                "TEST/LOSS/val_loss": test_loss, "TEST/recall": recall,
                "TEST/precision": precision, "TEST/hmean": hmean})
            if policy is not None:
                policy.on_epoch_end(state.state_dict(), train_loss=train_loss,
                                    test_loss=test_loss, hmean=hmean,
                                    epoch=epoch)
            if self.lrs_mode == "reduce":
                self.plateau.step(test_loss)
            history.append({"epoch": epoch, "train_loss": train_loss,
                            "test_loss": test_loss, "hmean": hmean})
        if policy is not None:
            policy.on_train_end(state.state_dict(), epochs)
        self.logger.info("Training completed")
        return state, history

    # ------------------------------------------------------------------
    def _scalars(self, step: int, values: dict) -> None:
        if self.tb_writer is not None:
            for tag, value in values.items():
                self.tb_writer.add_scalar(tag, value, step)

    def _grids(self, batch: dict, preds: torch.Tensor, mode: str) -> None:
        if self.tb_writer is not None:
            visualize_tfb(self.tb_writer, batch["img"],
                          preds.float().cpu().numpy(), self.global_step,
                          thresh=float(self.cfg.metric.thred_text_score),
                          mode=mode)
