"""Batch evaluation generator: inference and postprocess over a directory of
test images, written as the prediction pickles that the ``ioueval`` and
``deteval`` CLIs read, and with ``--gt_dir`` the GT pickle beside them.

Port of ``db_text_minimal_tpu/cli/make_eval.py``; the model runs on
``--device`` (CUDA by default). Rect mode takes ``DeviceBoxRepresenter`` on
the card unless ``--device_boxes false``; polygon mode (the default) takes
the host ``SegDetectorRepresenter``, as in the JAX package.

Usage::

    python -m db_text_minimal_tpu_torch.cli.make_eval --image_dir imgs/ \\
        --model_path models/best_cp.ckpt --gt_dir gts/ --dataset totaltext
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import sys

import numpy as np

from ..data.parsers import PARSERS
from ..postprocess import DeviceBoxRepresenter, SegDetectorRepresenter
from ..utils import filter_zero_boxes, read_img, str_to_bool, test_preprocess
from .common import build_inference_forward


def load_args(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--model_path", type=str,
                        default="./models/best_cp.ckpt")
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--save_dir", type=str, default="./assets")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="images per forward, each padded to the square "
                             "640 canvas")
    parser.add_argument("--thresh", type=float, default=0.3)
    parser.add_argument("--box_thresh", type=float, default=0.5)
    parser.add_argument("--unclip_ratio", type=float, default=1.5)
    parser.add_argument("--is_output_polygon", type=str_to_bool, default=True)
    parser.add_argument("--device_boxes", type=str_to_bool, default=True,
                        help="rect mode only: oriented boxes on the card "
                             "(DeviceBoxRepresenter); ignored in polygon "
                             "mode")
    parser.add_argument("--infer_mode", type=str, default="flax",
                        choices=("flax", "folded", "int8"),
                        help="flax = the plain module forward; folded and "
                             "int8 are not ported yet")
    parser.add_argument("--preds_fp", type=str,
                        default="./data/result_poly_preds.pkl")
    parser.add_argument("--img_fns_fp", type=str,
                        default="./data/img_fns.pkl")
    parser.add_argument("--gt_dir", type=str, default=None)
    parser.add_argument("--dataset", type=str, default="totaltext",
                        choices=sorted(PARSERS))
    parser.add_argument("--gts_fp", type=str,
                        default="./data/result_poly_gts.pkl")
    parser.add_argument("--ignore_tags", type=str, nargs="*",
                        default=["#", "###"])
    return parser.parse_args(argv)


def export_gts(args, img_fps: list[str]) -> None:
    """Write the GT pickle in the structure the evaluators read: per image
    a list of {"points", "text", "ignore"}."""
    parser = PARSERS[args.dataset]
    if args.dataset == "msra_td500":
        fps, anns = parser(args.gt_dir)
    else:
        fps, anns = parser(args.image_dir, args.gt_dir)
    by_name = {os.path.basename(fp): ann for fp, ann in zip(fps, anns)}
    gts = []
    for fp in img_fps:
        ann = by_name.get(os.path.basename(fp), [])
        gts.append([{"points": [tuple(p) for p in a["poly"]],
                     "text": a["text"],
                     "ignore": a["text"] in args.ignore_tags}
                    for a in ann])
    os.makedirs(os.path.dirname(args.gts_fp) or ".", exist_ok=True)
    with open(args.gts_fp, "wb") as f:
        pickle.dump(gts, f)
    print(f"wrote {len(gts)} GT entries to {args.gts_fp}")


def _represent(seg_obj, shape, preds, is_output_polygon):
    """The device representer takes the preds on their device, the host
    one a numpy copy."""
    if not isinstance(seg_obj, DeviceBoxRepresenter):
        preds = preds.cpu().numpy()
    return seg_obj({"shape": [shape]}, preds,
                   is_output_polygon=is_output_polygon)


def _predict_one(forward, seg_obj, args, img_origin, h_origin, w_origin):
    preds = forward(test_preprocess(img_origin))
    box_list, score_list = _represent(seg_obj, (h_origin, w_origin), preds,
                                      args.is_output_polygon)
    return filter_zero_boxes(box_list[0], score_list[0],
                             args.is_output_polygon)


def _predict_batched(forward, seg_obj, args, images, sizes,
                     canvas: int = 640):
    """One forward over the images padded to the square canvas, then the
    postprocess per image. An image's content fills [0, size·s) of the
    canvas at s = canvas / max(h, w), so rescaling to dest = max(h, w) maps
    the predictions back to the original coordinates, which are then
    clipped to the image."""
    preds = forward(np.concatenate(
        [test_preprocess(img, pad=True, size=canvas) for img in images]))
    results = []
    for i, (h_origin, w_origin) in enumerate(sizes):
        side = max(h_origin, w_origin)
        box_list, score_list = _represent(seg_obj, (side, side),
                                          preds[i:i + 1],
                                          args.is_output_polygon)
        boxes, scores = filter_zero_boxes(box_list[0], score_list[0],
                                          args.is_output_polygon)
        clipped = []
        for b in boxes:
            b = np.asarray(b).astype(np.float64)
            b[:, 0] = np.clip(b[:, 0], 0, w_origin)
            b[:, 1] = np.clip(b[:, 1], 0, h_origin)
            clipped.append(b.astype(np.int64))
        results.append((clipped, scores))
    return results


def _records(box_list):
    return [{"points": [tuple(p) for p in np.asarray(b).tolist()],
             "text": "text_sample", "ignore": False} for b in box_list]


def choose_representer(args):
    """``DeviceBoxRepresenter`` in rect mode with ``--device_boxes``, else
    the host representer, as the JAX make_eval chooses."""
    rep_cls = (DeviceBoxRepresenter
               if args.device_boxes and not args.is_output_polygon
               else SegDetectorRepresenter)
    return rep_cls(thresh=args.thresh, box_thresh=args.box_thresh,
                   unclip_ratio=args.unclip_ratio)


def main(args):
    _, forward = build_inference_forward(
        args.model_path, backbone=args.backbone, infer_mode=args.infer_mode,
        device=args.device)
    seg_obj = choose_representer(args)

    test_img_fps = sorted(glob.glob(os.path.join(args.image_dir, "*")))
    result_poly_preds = []
    img_fns = []
    if args.batch_size > 1:
        for start in range(0, len(test_img_fps), args.batch_size):
            chunk = test_img_fps[start:start + args.batch_size]
            images, sizes = [], []
            for fp in chunk:
                img_fns.append(fp.split("/")[-1])
                img, h, w = read_img(fp)
                images.append(img)
                sizes.append((h, w))
            try:
                for boxes, _ in _predict_batched(forward, seg_obj, args,
                                                 images, sizes):
                    result_poly_preds.append(_records(boxes))
            except Exception as e:
                print(type(e).__name__, e, chunk[0], file=sys.stderr)
                result_poly_preds.extend([[] for _ in chunk])
    else:
        for test_img_fp in test_img_fps:
            try:
                img_fns.append(test_img_fp.split("/")[-1])
                img_origin, h_origin, w_origin = read_img(test_img_fp)
                boxes, _ = _predict_one(forward, seg_obj, args, img_origin,
                                        h_origin, w_origin)
                result_poly_preds.append(_records(boxes))
            except Exception as e:   # one image's failure skips that image
                print(type(e).__name__, e, test_img_fp, file=sys.stderr)
                result_poly_preds.append([])

    os.makedirs(os.path.dirname(args.preds_fp) or ".", exist_ok=True)
    with open(args.preds_fp, "wb") as f:
        pickle.dump(result_poly_preds, f)
    with open(args.img_fns_fp, "wb") as f:
        pickle.dump(img_fns, f)
    print(f"wrote {len(result_poly_preds)} predictions to {args.preds_fp}")

    if args.gt_dir:
        export_gts(args, test_img_fps)


if __name__ == "__main__":
    main(load_args())
