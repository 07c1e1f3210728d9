"""Offline IoU-Pascal evaluation CLI over prediction and GT pickles.

Port of ``db_text_minimal_tpu/cli/ioueval.py``; the pickles are those of
``cli.make_eval``.
"""

from __future__ import annotations

import argparse
import pickle

from ..metrics import DetectionIoUEvaluator


def load_args(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--iou", type=float, default=0.5)
    parser.add_argument("--area", type=float, default=0.5)
    parser.add_argument("--poly_gts_fp", type=str,
                        default="./data/result_poly_gts.pkl")
    parser.add_argument("--poly_preds_fp", type=str,
                        default="./data/result_poly_preds.pkl")
    return parser.parse_args(argv)


def main(args):
    evaluator = DetectionIoUEvaluator(iou_constraint=args.iou,
                                      area_precision_constraint=args.area)
    with open(args.poly_gts_fp, "rb") as f:
        gts = pickle.load(f)
    with open(args.poly_preds_fp, "rb") as f:
        preds = pickle.load(f)
    results = [evaluator.evaluate_image(gt, pred)
               for gt, pred in zip(gts, preds)]
    metrics = evaluator.combine_results(results)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main(load_args())
