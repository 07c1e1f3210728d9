"""Quality benchmark: train on a dataset directory (or load a checkpoint),
then evaluate with every postprocess path (host and device, rect and
polygon) under both protocols (IoU-Pascal and DetEval), and write one
metrics JSON.

Port of ``db_text_minimal_tpu/cli/quality_bench.py``: ``load_args``,
``build_cfg``, ``_limit``, ``make_quant_forward`` (the int8 forward of
``--quant``), ``full_eval``, ``warn_ctw_polygon_operating_point`` and
``main``. The report has the JAX report's keys; ``config.backend`` is the
torch device's type (``"cuda"``), ``config.compute_dtype`` beside it the
model's (``"bfloat16"`` on CUDA under the default configuration, as the JAX
package on its accelerator; ``"float32"`` on the CPU), and each
``history`` entry also holds the epoch's wall seconds, the seconds the
step waited on the loader and the mean host ms of a sample in a loader
thread. ``--dump_eval_dir`` writes each test batch's preds and every
representer's boxes, under the JAX package's file names and keys.

Usage::

    python -m db_text_minimal_tpu_torch.cli.quality_bench \
        --data_dir tmp/hb --out demo/hard_bench_torch/metrics.json \
        --epochs 10 [--reduction none] [--polygon] [--save_checkpoint CKPT]
        [--eval_only --checkpoint CKPT [--quant]] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

from ..config import load_config
from ..data import DataLoader, build_dataset
from ..metrics import (DetectionDetEvalEvaluator, DetectionIoUEvaluator,
                       QuadMetric)
from ..models.head import fuse_variables
from ..models.prune import load_widths, save_widths
from ..models.quant_infer import DEFAULT_SKIP
from ..postprocess import (DeviceBoxRepresenter, DevicePolyRepresenter,
                           SegDetectorRepresenter)
from ..train.checkpoints import save_checkpoint
from ..train.trainer import Trainer, device_preprocess, to_device
from ..utils import CAFFE_MEAN, resolve_device
from .common import make_folded_forward


def load_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True,
                        help="TotalText-format dataset root "
                             "(train_images/ train_gts/ test_images/ "
                             "test_gts/)")
    parser.add_argument("--out", type=str, required=True,
                        help="metrics JSON path")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--test_batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=0.005)
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--neck", type=str, default="FPN")
    parser.add_argument("--reduction", type=str, default="mean",
                        choices=("mean", "none"))
    parser.add_argument("--lrs", type=str, default="reduce",
                        choices=("reduce", "poly"),
                        help="poly = warmup + polynomial decay over the "
                             "whole training horizon")
    parser.add_argument("--lrs_max_iters", type=int, default=0,
                        help="the poly decay horizon in steps (default: "
                             "epochs x batches per epoch)")
    parser.add_argument("--no_final_eval", action="store_true",
                        help="skip the end-of-run eval (the first segments "
                             "of a run split across processes)")
    parser.add_argument("--pretrained_backbone", type=str, default=None)
    parser.add_argument("--dcn_offset_lr_mult", type=float, default=1.0)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="warm start, or the weights of --eval_only")
    parser.add_argument("--eval_only", action="store_true")
    parser.add_argument("--limit_train", type=int, default=None)
    parser.add_argument("--limit_test", type=int, default=None)
    parser.add_argument("--eval_every", type=int, default=0,
                        help="run the in-loop eval every N epochs (0: only "
                             "the final eval)")
    # the reference's eval constants (Makefile:26-28)
    parser.add_argument("--thresh", type=float, default=0.25)
    parser.add_argument("--box_thresh", type=float, default=0.50)
    parser.add_argument("--unclip_ratio", type=float, default=None,
                        help="default 1.5; --line_level makes it 2.5")
    parser.add_argument("--line_level", action="store_true",
                        help="line-level polygon preset (the CTW1500 "
                             "protocol): implies --polygon and, unless "
                             "--unclip_ratio is given, unclip 2.5")
    parser.add_argument("--save_checkpoint", type=str, default=None,
                        help="save the trained state here, before the "
                             "final eval")
    parser.add_argument("--img_size", type=int, default=640)
    parser.add_argument("--quant", action="store_true",
                        help="evaluate the int8 inference forward "
                             "(BN-folded, the wide convs int8, static "
                             "scales) instead of the float model")
    parser.add_argument("--quant_head", action="store_true",
                        help="with --quant: also quantize the fused head's "
                             "256->128 conv")
    parser.add_argument("--dataset_format", type=str, default="totaltext",
                        choices=("totaltext", "ctw1500"))
    parser.add_argument("--polygon", action="store_true",
                        help="also evaluate the polygon-mode postprocess, "
                             "on the host and on the device")
    parser.add_argument("--dump_eval_dir", type=str, default=None,
                        help="save each test batch's preds (f32, "
                             "batch_NNN.npz) and each representer's boxes "
                             "and scores (batch_NNN.boxes.pkl) in "
                             "full_eval, to replay a divergence offline")
    args = parser.parse_args(argv)
    if args.line_level:
        args.polygon = True
    if args.unclip_ratio is None:
        args.unclip_ratio = 2.5 if args.line_level else 1.5
    return args


def _limit(dataset, n):
    """The first ``n`` samples of ``dataset`` (all when ``n`` is 0 or
    None)."""
    if n:
        dataset.image_paths = dataset.image_paths[:n]
        dataset.all_anns = dataset.all_anns[:n]
    return dataset


def build_cfg(args):
    """The training configuration of a quality run: the defaults with the
    dataset, schedule and eval constants of ``args``."""
    fmt = args.dataset_format
    section = {
        "train_dir": os.path.join(args.data_dir, "train_images"),
        "train_gt_dir": os.path.join(args.data_dir, "train_gts"),
        "test_dir": os.path.join(args.data_dir, "test_images"),
        "test_gt_dir": os.path.join(args.data_dir, "test_gts"),
        "ignore_tags": ["###"],
    }
    overrides = {
        "meta": {"device": args.device},
        "dataset": {"name": fmt},
        "data": {fmt: section},
        "hps": {"batch_size": args.batch_size,
                "test_batch_size": args.test_batch_size,
                "no_epochs": args.epochs, "img_size": args.img_size,
                "log_iter": 25},
        "metric": {"thred_text_score": args.thresh,
                   "prob_threshold": args.box_thresh,
                   "unclip_ratio": args.unclip_ratio,
                   "is_output_polygon": False},
        "model": {"backbone": args.backbone, "neck": args.neck,
                  "head": "DBHead",
                  "pretrained_backbone_path": args.pretrained_backbone or "",
                  "finetune_cp_path": "",
                  # a pruned checkpoint's widths: the Trainer builds the
                  # narrow model from them
                  "widths": (load_widths(args.checkpoint)
                             if args.checkpoint else None)},
        "optimizer": {"lr": args.lr, "reduction": args.reduction,
                      "dcn_offset_lr_mult": args.dcn_offset_lr_mult},
        "lrs": ({"mode": "poly", "warmup_iters": 100,
                 "max_iters": args.lrs_max_iters or args.epochs * max(
                     (args.limit_train or 1600) // args.batch_size, 1)}
                if args.lrs == "poly"
                else {"mode": "reduce", "factor": 0.2, "patience": 4}),
    }
    return load_config("/nonexistent-use-defaults", overrides)


def make_quant_forward(trainer, state, test_loader, args):
    """The int8 forward of the trained model (``--quant``): its weights in
    the ``FusedDBHead`` layout, BN folded, the wide convs int8 (the head's
    conv1 too with ``--quant_head``), activation scales calibrated on the
    first 2 images of the first test batch (mean-subtracted when uint8).
    Returns ``forward(device_batch)`` -> NHWC (prob, thresh) maps, the
    signature ``full_eval`` takes."""
    first = next(iter(test_loader))
    cal_img = np.asarray(first["img"]).astype(np.float32)
    if np.asarray(first["img"]).dtype == np.uint8:
        cal_img = cal_img - np.asarray(CAFFE_MEAN, np.float32)
    folded = make_folded_forward(
        fuse_variables(state.model.state_dict()), quantize=True,
        calibration=[cal_img[:2]],
        skip=() if args.quant_head else DEFAULT_SKIP, device=trainer.device)

    def forward(device_batch):
        return folded(device_preprocess(device_batch)["img"])

    return forward


def full_eval(trainer, state, test_loader, args, forward=None):
    """Forward the test set once and evaluate every representer on the
    same preds: rows ``host`` and ``device`` (rect mode) and, with
    ``args.polygon``, ``host_poly`` and ``device_poly``, each under
    IoU-Pascal (0.4 / 0.8) and DetEval (tr 0.8 / tp 0.4), with each row's
    postprocess wall time. ``forward(device_batch)`` gives the NHWC preds
    (default: the trainer's eval step). The first batch is run once
    untimed, so first-call builds are not charged to one row; the host rows
    share one host copy of each batch's preds, made untimed. With
    ``args.dump_eval_dir`` each batch's preds go to ``batch_NNN.npz``
    (key ``preds``, float32) and ``{row: (boxes, scores)}`` to
    ``batch_NNN.boxes.pkl``."""
    size = args.img_size
    if forward is None:
        def forward(device_batch):
            return trainer._eval_step(state, device_batch)[0]
    host_rep = SegDetectorRepresenter(
        thresh=args.thresh, box_thresh=args.box_thresh,
        unclip_ratio=args.unclip_ratio)
    # name -> (representer, is_output_polygon)
    reps = {
        "host": (host_rep, False),
        "device": (DeviceBoxRepresenter(
            thresh=args.thresh, box_thresh=args.box_thresh,
            unclip_ratio=args.unclip_ratio), False),
    }
    if args.polygon:
        reps["host_poly"] = (host_rep, True)
        try:
            reps["device_poly"] = (DevicePolyRepresenter(
                thresh=args.thresh, box_thresh=args.box_thresh,
                unclip_ratio=args.unclip_ratio), True)
        except ValueError as e:
            # box_thresh <= thresh: the device polygon path would differ
            # from the host's, so only the host polygon row is reported
            print(f"# device_poly skipped: {e}", file=sys.stderr)
    evaluators = {
        "iou_pascal": DetectionIoUEvaluator(iou_constraint=0.4,
                                            area_precision_constraint=0.8),
        "deteval": DetectionDetEvalEvaluator(),
    }
    raw = {(r, e): [] for r in reps for e in evaluators}
    wall = {r: 0.0 for r in reps}
    n_images = 0
    dump_dir = getattr(args, "dump_eval_dir", None)
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
    for batch_idx, batch in enumerate(test_loader):
        preds = forward(to_device(batch, trainer.device))
        preds_np = preds.cpu().numpy()
        batch_shape = {"shape": [(size, size)] * preds.shape[0]}

        def run(rname):
            rep, is_poly = reps[rname]
            pred_in = preds if rname.startswith("device") else preds_np
            return rep(batch_shape, pred_in, is_output_polygon=is_poly)

        if n_images == 0:
            for rname in reps:
                run(rname)
        dump_rec = {}
        for rname in reps:
            t0 = time.perf_counter()
            output = run(rname)
            wall[rname] += time.perf_counter() - t0
            dump_rec[rname] = output
            for ename, ev in evaluators.items():
                raw[(rname, ename)].append(
                    QuadMetric(evaluator=ev).validate_measure(batch, output))
        n_images += preds.shape[0]
        if dump_dir:
            name = os.path.join(dump_dir, f"batch_{batch_idx:03d}")
            np.savez_compressed(name + ".npz",
                                preds=preds_np.astype(np.float32))
            with open(name + ".boxes.pkl", "wb") as f:
                pickle.dump(dump_rec, f)
    out = {}
    for (rname, ename), metrics in raw.items():
        gathered = QuadMetric(evaluator=evaluators[ename]).gather_measure(
            metrics)
        out.setdefault(rname, {})[ename] = {
            "precision": round(gathered["precision"].avg, 4),
            "recall": round(gathered["recall"].avg, 4),
            "hmean": round(gathered["fmeasure"].avg, 4),
        }
    for rname in reps:
        out[rname]["postprocess_wall_s"] = round(wall[rname], 2)
    out["n_test_images"] = n_images
    return out


def warn_ctw_polygon_operating_point(args) -> bool:
    """CTW1500 line-level polygon eval at the reference's default unclip
    1.5 under-covers its GT lines, so DetEval's coverage gate fails almost
    every match (the JAX package's docs/PERFORMANCE.md, section CTW); warn
    on stderr when that operating point is asked for."""
    if (args.dataset_format == "ctw1500" and args.polygon
            and args.unclip_ratio < 2.0):
        print(
            f"# WARNING: ctw1500 polygon mode at unclip_ratio="
            f"{args.unclip_ratio} collapses DetEval on line-level text; "
            f"line-level polygon evals should run --unclip_ratio 2.5.",
            file=sys.stderr)
        return True
    return False


def main(args=None):
    args = args or load_args()
    resolve_device(args.device)   # refuse a missing GPU before any work
    warn_ctw_polygon_operating_point(args)
    cfg = build_cfg(args)
    train_ds = _limit(build_dataset(cfg, is_training=True), args.limit_train)
    test_ds = _limit(build_dataset(cfg, is_training=False), args.limit_test)
    section = cfg.data[cfg.dataset.name]
    for dataset, where in ((train_ds, section.train_dir),
                           (test_ds, section.test_dir)):
        if not len(dataset) and not (args.eval_only and dataset is train_ds):
            raise FileNotFoundError(f"no images in {where}")
    train_loader = DataLoader(train_ds, int(cfg.hps.batch_size),
                              shuffle=True)
    test_loader = DataLoader(test_ds, int(cfg.hps.test_batch_size))
    trainer = Trainer(cfg, train_loader, test_loader)
    t0 = time.perf_counter()
    history = []
    if args.eval_only:
        assert args.checkpoint, "--eval_only requires --checkpoint"
        state = trainer.resume_state(args.checkpoint)
    else:
        state = (trainer.resume_state(args.checkpoint) if args.checkpoint
                 else trainer.init_state())
        for epoch in range(int(cfg.hps.no_epochs)):
            state, train_loss, _, _ = trainer.train_epoch(state, epoch)
            seconds = train_loader.sample_seconds
            entry = {"epoch": epoch, "train_loss": round(train_loss, 5),
                     "wall_s": round(trainer.epoch_timing["wall_s"], 2),
                     "loader_wait_s": round(
                         trainer.epoch_timing["loader_wait_s"], 2),
                     "sample_ms": round(1e3 * float(np.mean(seconds)), 2)
                     if seconds else None}
            if args.eval_every and (epoch + 1) % args.eval_every == 0:
                test_loss, _, recall, precision, hmean = \
                    trainer.eval_epoch(state)
                entry.update({"test_loss": round(test_loss, 5),
                              "hmean": round(hmean, 4)})
                if trainer.lrs_mode == "reduce":
                    trainer.plateau.step(test_loss)
            trainer.logger.info("epoch %d: %s", epoch, entry)
            history.append(entry)
    train_wall = time.perf_counter() - t0

    train_config = {
        "backbone": args.backbone, "neck": args.neck,
        "reduction": args.reduction,
        "pretrained_backbone": bool(args.pretrained_backbone),
        "epochs": args.epochs, "batch_size": args.batch_size,
        "lr": args.lr, "lrs": args.lrs,
        "dcn_offset_lr_mult": args.dcn_offset_lr_mult,
    }
    # saved before the final eval, so a failing eval never loses the
    # training; the sidecar records how the checkpoint was trained
    if args.save_checkpoint:
        save_checkpoint(args.save_checkpoint, state.state_dict())
        with open(args.save_checkpoint + ".train_config.json", "w") as f:
            json.dump(train_config, f)
        # a fine-tuned pruned model keeps its widths, so that the new
        # checkpoint loads (JAX quality_bench.py:398-403)
        if cfg.model.widths:
            save_widths(args.save_checkpoint, dict(cfg.model.widths))

    if args.no_final_eval:
        results, eval_wall = {"skipped": True}, 0.0
    else:
        forward = (make_quant_forward(trainer, state, test_loader, args)
                   if args.quant else None)
        t0 = time.perf_counter()
        results = full_eval(trainer, state, test_loader, args,
                            forward=forward)
        eval_wall = time.perf_counter() - t0

    if args.eval_only:
        sidecar = (args.checkpoint or "") + ".train_config.json"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                train_config = json.load(f)
        else:
            train_config = {"unknown": "checkpoint has no "
                            ".train_config.json sidecar; training "
                            "hyperparameters not recorded"}

    report = {
        "config": {
            "eval_only": bool(args.eval_only),
            "checkpoint": args.checkpoint,
            "train_config": train_config,
            "thresh": args.thresh,
            "box_thresh": args.box_thresh,
            "unclip_ratio": args.unclip_ratio,
            "n_train": len(train_ds), "n_test": len(test_ds),
            "backend": trainer.device.type,
            "compute_dtype": str(trainer.compute_dtype).removeprefix(
                "torch."),
            "quant": bool(args.quant), "quant_head": bool(args.quant_head),
        },
        "train_wall_s": round(train_wall, 1),
        "eval_wall_s": round(eval_wall, 1),
        "history": history,
        "results": results,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report["results"], indent=1))
    return report


if __name__ == "__main__":
    main()
