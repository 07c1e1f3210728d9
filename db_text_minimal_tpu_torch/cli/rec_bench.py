"""Recognition quality benchmark: word accuracy and end-to-end OCR P/R/F.

Port of ``db_text_minimal_tpu/cli/rec_bench.py``, one JSON report each,
with the JAX reports' keys:

- ``--mode rec``: word accuracy on the GT word crops of a dataset's test
  split (train the recognizer with ``cli/train_rec`` on crops exported
  from the train split first); ``--distort`` evaluates the deterministic
  distorted split instead.
- ``--mode e2e``: detect -> warp -> recognize over the test split. The
  detections of each image, sorted by confidence, are matched greedily to
  the GT polygons at IoU >= ``--iou_match``; an end-to-end hit needs the
  match and an exact (charset-filtered, case-folded) transcription.

The crops are warped one at a time on the host by the geometry library and
recognized in chunks of 64 (the last chunk as it is: a crop's result does
not depend on its chunk). The detector is the plain model in its default
compute dtype (bfloat16 on CUDA), detections go through the host
``SegDetectorRepresenter`` in rect mode. Both models run on ``--device``,
CUDA by default.

Usage::

    python -m db_text_minimal_tpu_torch.cli.rec_bench --mode rec \\
        --data_dir tmp/glyph_bench --saved_model tmp/rec.ckpt \\
        --out demo/ocr_torch/rec_accuracy.json
    python -m db_text_minimal_tpu_torch.cli.rec_bench --mode e2e \\
        --data_dir tmp/glyph_bench --saved_model tmp/rec.ckpt \\
        --det_model_path tmp/det.ckpt --out demo/ocr_torch/ocr_e2e.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..metrics.iou import polygon_iou
from ..models.recognition import predict_batch, rec_preprocess
from ..ops import geometry as geo
from ..postprocess import SegDetectorRepresenter, order_rect_points
from .ocr import build_converter, load_rec_model


def load_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", type=str, required=True,
                        choices=("rec", "e2e"))
    parser.add_argument("--data_dir", type=str, required=True,
                        help="TotalText-format dataset root")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--saved_model", type=str, required=True,
                        help="recognition checkpoint")
    parser.add_argument("--det_model_path", type=str, default=None,
                        help="detector checkpoint (e2e mode)")
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--thresh", type=float, default=0.25)
    parser.add_argument("--box_thresh", type=float, default=0.50)
    parser.add_argument("--unclip_ratio", type=float, default=1.5)
    parser.add_argument("--iou_match", type=float, default=0.5)
    parser.add_argument("--distort", action="store_true",
                        help="rec mode: evaluate on the deterministic "
                             "distorted split (rotation/perspective/"
                             "curve/noise/blur) instead of clean crops")
    parser.add_argument("--distort_seed", type=int, default=1234)
    parser.add_argument("--character", type=str,
                        default="0123456789abcdefghijklmnopqrstuvwxyz")
    parser.add_argument("--batch_max_length", type=int, default=25)
    parser.add_argument("--imgH", type=int, default=32)
    parser.add_argument("--imgW", type=int, default=100)
    parser.add_argument("--PAD", action="store_true")
    parser.add_argument("--Transformation", type=str, default="None")
    parser.add_argument("--FeatureExtraction", type=str, default="VGG")
    parser.add_argument("--SequenceModeling", type=str, default="BiLSTM")
    parser.add_argument("--Prediction", type=str, default="CTC")
    parser.add_argument("--num_fiducial", type=int, default=20)
    parser.add_argument("--input_channel", type=int, default=1)
    parser.add_argument("--output_channel", type=int, default=512)
    parser.add_argument("--hidden_size", type=int, default=256)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def _norm_text(text: str, charset: str) -> str:
    return "".join(c for c in text.lower() if c in charset)


def _test_words(args):
    """(image RGB, [(poly, text), ...]) per test image, ignores dropped."""
    import cv2

    from ..data.parsers import load_totaltext

    fps, anns = load_totaltext(os.path.join(args.data_dir, "test_images"),
                               os.path.join(args.data_dir, "test_gts"))
    if args.limit:
        fps, anns = fps[:args.limit], anns[:args.limit]
    for fp, ann in zip(fps, anns):
        img = cv2.imread(fp)[:, :, ::-1]
        words = [(np.asarray(it["poly"], np.float64), it["text"])
                 for it in ann if it["text"] != "###"]
        yield np.ascontiguousarray(img), words


def _warp_crop(img, poly, img_w=100, img_h=32):
    dst = np.array([[0, 0], [img_w, 0], [img_w, img_h], [0, img_h]],
                   np.float64)
    if len(poly) != 4:
        # rectify via the min-area rect of the polygon, its corners ordered
        # clockwise from the top left to align with dst (min_area_rect
        # starts at an arbitrary hull edge, which would rotate the crop)
        rect, _ = geo.min_area_rect(np.asarray(poly, np.float64))
        poly = np.asarray(order_rect_points(np.asarray(rect)), np.float64)
    matrix = geo.get_perspective_transform(poly, dst)
    return geo.warp_perspective(img, matrix, (img_w, img_h))


def distort_crop(crop: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Deterministic hard-mode distortion of an eval crop, seeded per word
    so every model sees the same distorted split: perspective corner jitter
    and rotation (through the geometry library's warp), a vertical sine
    curve, a contrast/brightness shift, Gaussian noise and, half the time,
    a 3x3 box blur."""
    h, w = crop.shape[:2]
    out = crop.astype(np.float64)

    # perspective + rotation: jitter each corner up to 5% of the side and
    # rotate up to +-9 degrees about the center
    ang = rng.uniform(-9, 9) * np.pi / 180.0
    c, s = np.cos(ang), np.sin(ang)
    cx, cy = w / 2.0, h / 2.0
    corners = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
    rot = np.stack([(corners[:, 0] - cx) * c - (corners[:, 1] - cy) * s + cx,
                    (corners[:, 0] - cx) * s + (corners[:, 1] - cy) * c + cy],
                   axis=1)
    src = rot + rng.uniform(-0.05, 0.05, (4, 2)) * np.array([w, h])
    matrix = geo.get_perspective_transform(
        src, np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float64))
    out = geo.warp_perspective(out.astype(np.uint8), matrix,
                               (w, h)).astype(np.float64)

    # vertical sine curve: shift each column by a half-period sine
    amp = rng.uniform(0.0, 0.06) * h
    phase = rng.uniform(0, 2 * np.pi)
    shifts = (amp * np.sin(np.linspace(0, np.pi, w) + phase)).astype(int)
    for x_ in range(w):
        out[:, x_] = np.roll(out[:, x_], shifts[x_], axis=0)

    # photometric: contrast/brightness then noise then blur
    out = out * rng.uniform(0.75, 1.15) + rng.uniform(-18, 18)
    out = out + rng.normal(0.0, rng.uniform(2, 8), out.shape)
    if rng.random() < 0.5:  # 3x3 box blur, separable
        k = np.ones(3) / 3.0
        out = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 0, out)
        out = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 1, out)
    return np.clip(out, 0, 255).astype(np.uint8)


def _predict_chunked(tensors_list, converter, model, args, batch: int = 64):
    """``predict_batch`` over chunks of ``batch`` crops, one forward
    each."""
    results = []
    for i in range(0, len(tensors_list), batch):
        chunk = tensors_list[i:i + batch]
        results.extend(predict_batch(np.concatenate(chunk, axis=0),
                                     converter, model,
                                     prediction=args.Prediction,
                                     batch_max_length=args.batch_max_length))
    return results


def run_rec(args):
    """Word accuracy on held-out GT crops (test split)."""
    converter = build_converter(args)
    model = load_rec_model(args, len(converter.character))
    correct = total = 0
    conf_sum = 0.0
    per_image = []
    word_idx = 0
    tensors_list, gt_list = [], []
    for img, words in _test_words(args):
        for poly, text in words:
            gt = _norm_text(text, args.character)
            if not gt:
                continue
            try:
                crop = _warp_crop(img, poly, args.imgW, args.imgH)
            except ValueError:
                continue
            if args.distort:
                crop = distort_crop(
                    crop, np.random.default_rng(args.distort_seed + word_idx))
            word_idx += 1
            tensors_list.append(rec_preprocess(crop, img_h=args.imgH,
                                               img_w=args.imgW, pad=args.PAD))
            gt_list.append(gt)
    for gt, res in zip(gt_list, _predict_chunked(tensors_list, converter,
                                                 model, args)):
        ok = res["pred"] == gt
        correct += int(ok)
        total += 1
        conf_sum += res["score"]
        if not ok and len(per_image) < 20:
            per_image.append({"gt": gt, "pred": res["pred"]})
    return {
        "mode": "rec",
        "distort": bool(args.distort),
        "word_accuracy": round(correct / max(total, 1), 4),
        "correct": correct,
        "total": total,
        "mean_confidence": round(conf_sum / max(total, 1), 4),
        "sample_errors": per_image,
    }


def run_e2e(args):
    """Detect -> warp -> recognize over the test split; IoU-matched e2e
    P/R/F (``src/test_ocr.py:111-210`` pipeline)."""
    from ..utils import test_preprocess
    from .common import load_model, make_forward

    assert args.det_model_path, "--mode e2e requires --det_model_path"
    converter = build_converter(args)
    rec_model = load_rec_model(args, len(converter.character))
    det_fwd = make_forward(load_model(args.det_model_path, device=args.device,
                                      backbone=args.backbone))
    rep = SegDetectorRepresenter(thresh=args.thresh,
                                 box_thresh=args.box_thresh,
                                 unclip_ratio=args.unclip_ratio)
    n_det = n_gt = det_match = e2e_match = 0
    n_images = 0
    pending_tensors, pending_gts = [], []
    for img, words in _test_words(args):
        n_images += 1
        h, w = img.shape[:2]
        preds = det_fwd(test_preprocess(img, pad=False)).float().cpu()
        box_list, score_list = rep({"shape": [(h, w)]}, preds.numpy(),
                                   is_output_polygon=False)
        # confidence-sorted greedy matching: without the sort an early
        # low-IoU box can claim a GT a later box overlaps better
        scored = [(b, s) for b, s in zip(box_list[0], score_list[0])
                  if np.abs(np.asarray(b)).sum() > 0]
        scored.sort(key=lambda bs: -float(bs[1]))
        boxes = [b for b, _ in scored]
        gts = [(poly, _norm_text(text, args.character))
               for poly, text in words]
        # run_rec skips words that normalize to nothing; so does e2e, so an
        # empty recognizer output cannot count as a correct hit
        gts = [(p_, t) for p_, t in gts if t]
        n_gt += len(gts)
        n_det += len(boxes)
        used = set()
        for box in boxes:
            best_j, best_iou = -1, 0.0
            for j, (poly, _) in enumerate(gts):
                if j in used:
                    continue
                iou = polygon_iou(np.asarray(box, np.float64), poly)
                if iou > best_iou:
                    best_j, best_iou = j, iou
            if best_iou < args.iou_match:
                continue
            used.add(best_j)
            det_match += 1
            try:
                crop = _warp_crop(img, np.asarray(box, np.float64),
                                  args.imgW, args.imgH)
            except ValueError:
                continue
            # recognition is deferred: all matched crops of the split run
            # as one chunked batch
            pending_tensors.append(rec_preprocess(crop, img_h=args.imgH,
                                                  img_w=args.imgW,
                                                  pad=args.PAD))
            pending_gts.append(gts[best_j][1])
    for gt, res in zip(pending_gts, _predict_chunked(
            pending_tensors, converter, rec_model, args)):
        if res["pred"] == gt:
            e2e_match += 1
    det_p = det_match / max(n_det, 1)
    det_r = det_match / max(n_gt, 1)
    e2e_p = e2e_match / max(n_det, 1)
    e2e_r = e2e_match / max(n_gt, 1)
    return {
        "mode": "e2e",
        "n_images": n_images, "n_gt_words": n_gt, "n_detections": n_det,
        "det_precision": round(det_p, 4), "det_recall": round(det_r, 4),
        "det_hmean": round(2 * det_p * det_r / max(det_p + det_r, 1e-9), 4),
        "e2e_precision": round(e2e_p, 4), "e2e_recall": round(e2e_r, 4),
        "e2e_hmean": round(2 * e2e_p * e2e_r / max(e2e_p + e2e_r, 1e-9), 4),
    }


def main(args=None):
    args = args or load_args()
    report = run_rec(args) if args.mode == "rec" else run_e2e(args)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
