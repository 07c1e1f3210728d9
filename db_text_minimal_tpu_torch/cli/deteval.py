"""Offline DetEval evaluation CLI over prediction and GT pickles.

Port of ``db_text_minimal_tpu/cli/deteval.py``; the pickles are those of
``cli.make_eval``.
"""

from __future__ import annotations

import argparse
import pickle

from ..metrics import DetectionDetEvalEvaluator


def load_args(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--tp", type=float, default=0.4)
    parser.add_argument("--tr", type=float, default=0.8)
    parser.add_argument("--poly_gts_fp", type=str,
                        default="./data/result_poly_gts.pkl")
    parser.add_argument("--poly_preds_fp", type=str,
                        default="./data/result_poly_preds.pkl")
    return parser.parse_args(argv)


def main(args):
    evaluator = DetectionDetEvalEvaluator(area_recall_constraint=args.tr,
                                          area_precision_constraint=args.tp)
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
