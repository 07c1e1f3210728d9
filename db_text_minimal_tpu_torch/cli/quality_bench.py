"""Quality benchmark: evaluate a trained model with every postprocess path
(host and device, rect and polygon) under both protocols (IoU-Pascal and
DetEval).

Port of ``db_text_minimal_tpu/cli/quality_bench.py``: ``load_args``,
``build_cfg``, ``make_quant_forward`` (the int8 forward of ``--quant``),
``full_eval`` and ``warn_ctw_polygon_operating_point``.
``main``, which trains on a dataset directory, needs the cv2 datasets
(``build_dataset``), which are not ported yet; until then it raises.
``full_eval`` takes any trainer and loader of batch dicts, for example
batches of ``data.scenes.text_batch``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..config import load_config
from ..metrics import (DetectionDetEvalEvaluator, DetectionIoUEvaluator,
                       QuadMetric)
from ..models.head import fuse_variables
from ..models.quant_infer import DEFAULT_SKIP
from ..postprocess import (DeviceBoxRepresenter, DevicePolyRepresenter,
                           SegDetectorRepresenter)
from ..train.trainer import device_preprocess, to_device
from ..utils import CAFFE_MEAN
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
    parser.add_argument("--pretrained_backbone", type=str, default=None)
    parser.add_argument("--dcn_offset_lr_mult", type=float, default=1.0)
    parser.add_argument("--limit_train", type=int, default=None)
    # the reference's eval constants (Makefile:26-28)
    parser.add_argument("--thresh", type=float, default=0.25)
    parser.add_argument("--box_thresh", type=float, default=0.50)
    parser.add_argument("--unclip_ratio", type=float, default=None,
                        help="default 1.5; --line_level makes it 2.5")
    parser.add_argument("--line_level", action="store_true",
                        help="line-level polygon preset (the CTW1500 "
                             "protocol): implies --polygon and, unless "
                             "--unclip_ratio is given, unclip 2.5")
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
    args = parser.parse_args(argv)
    if args.line_level:
        args.polygon = True
    if args.unclip_ratio is None:
        args.unclip_ratio = 2.5 if args.line_level else 1.5
    return args


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
                  "finetune_cp_path": ""},
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
    share one host copy of each batch's preds, made untimed."""
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
    for batch in test_loader:
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
        for rname in reps:
            t0 = time.perf_counter()
            output = run(rname)
            wall[rname] += time.perf_counter() - t0
            for ename, ev in evaluators.items():
                raw[(rname, ename)].append(
                    QuadMetric(evaluator=ev).validate_measure(batch, output))
        n_images += preds.shape[0]
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
    warn_ctw_polygon_operating_point(args)
    raise NotImplementedError(
        "quality_bench.main trains on a dataset directory through "
        "data.build_dataset and the cv2 datasets, which are not ported yet "
        "(ROADMAP 'Still open' item 1); full_eval runs on any loader")


if __name__ == "__main__":
    main()
