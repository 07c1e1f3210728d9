"""Webcam or video detection, with optional recognition of each box.

Port of ``db_text_minimal_tpu/cli/webcam.py`` (the reference's
``src/test_webcam.py``): frames from a camera or a video file, detection
on every ``--per_frame``-th one (``build_inference_forward``,
``--infer_mode flax|folded|int8``, then the host ``SegDetectorRepresenter``
in rect mode), with ``--recognize`` each box warped to 32x100 and read by
``cli/ocr``'s recognizer; the boxes and words drawn on the frame, which is
shown (``--show_video``) and, for a video file, written to ``--out_path``
(mp4v, 640x480, 20 frames/s). Both models run on ``--device``, CUDA by
default.

Usage::

    python -m db_text_minimal_tpu_torch.cli.webcam --video_path in.mp4 \\
        --det_model_path models/best_cp.ckpt --per_frame 1 \\
        [--recognize --saved_model models/rec.ckpt] [--show_video]
        [--out_path ./tmp/out.mp4] [--max_frames N] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..ops import geometry as geo
from ..postprocess import SegDetectorRepresenter
from ..utils import (draw_bbox, filter_zero_boxes, resolve_device,
                     str_to_bool, test_preprocess)
from .common import INFER_MODES, build_inference_forward
from .ocr import build_converter, load_rec_model, recognize_crops


def load_args(argv=None):
    """``src/test_webcam.py:27-116``."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--recognize", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--show_video", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--saved_model", type=str, default=None)
    parser.add_argument("--det_model_path", type=str, required=True)
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--save_dir", type=str, default="./assets")
    parser.add_argument("--video_path", type=str, default="")
    parser.add_argument("--out_path", type=str, default="./tmp/out.mp4")
    parser.add_argument("--per_frame", type=int, default=5)
    parser.add_argument("--max_frames", type=int, default=0,
                        help="stop after N frames (0 = run until EOF/q)")
    parser.add_argument("--prob_thred", type=float, default=0.5)
    parser.add_argument("--heatmap", type=str_to_bool, default=False)
    parser.add_argument("--thresh", type=float, default=0.30)
    parser.add_argument("--box_thresh", type=float, default=0.62)
    parser.add_argument("--unclip_ratio", type=float, default=1.5)
    parser.add_argument("--alpha", type=float, default=0.6)
    parser.add_argument("--num_class", type=int, default=38)
    parser.add_argument("--batch_max_length", type=int, default=25)
    parser.add_argument("--imgH", type=int, default=32)
    parser.add_argument("--imgW", type=int, default=100)
    parser.add_argument("--rgb", action="store_true")
    parser.add_argument("--character", type=str,
                        default="0123456789abcdefghijklmnopqrstuvwxyz")
    parser.add_argument("--sensitive", action="store_true")
    parser.add_argument("--PAD", action="store_true")
    parser.add_argument("--Transformation", type=str, default="None")
    parser.add_argument("--FeatureExtraction", type=str, default="ResNet")
    parser.add_argument("--SequenceModeling", type=str, default="BiLSTM")
    parser.add_argument("--Prediction", type=str, default="Attn")
    parser.add_argument("--num_fiducial", type=int, default=20)
    parser.add_argument("--infer_mode", type=str, default="flax",
                        choices=INFER_MODES,
                        help="detector forward: the plain model, or the "
                             "BN-folded / int8 prob-only forward of the "
                             "flagship configuration")
    parser.add_argument("--input_channel", type=int, default=1)
    parser.add_argument("--output_channel", type=int, default=512)
    parser.add_argument("--hidden_size", type=int, default=256)
    args = parser.parse_args(argv)
    if args.rgb:
        args.input_channel = 3
    return args


def process_frame(args, frame, forward, seg_obj, rec=None):
    """Detect (and with ``rec`` = (converter, recognizer) recognize) the
    boxes of one BGR frame; returns the frame with them drawn. The crops
    are cut from the frame after its boxes are drawn, as in JAX."""
    import cv2

    h_origin, w_origin = frame.shape[:2]
    img = test_preprocess(frame[:, :, ::-1], pad=False)

    start = time.time()
    preds = forward(img).float().cpu().numpy()
    print(">>> Detect: {}'s".format(time.time() - start))

    batch = {"shape": [(h_origin, w_origin)]}
    box_list, score_list = seg_obj(batch, preds, is_output_polygon=False)
    box_list, score_list = filter_zero_boxes(box_list[0], score_list[0],
                                             False)
    frame = draw_bbox(frame, np.array(box_list), color=(0, 0, 255),
                      thickness=1)

    if args.recognize and rec is not None and len(box_list):
        converter, rec_model = rec
        h_, w_ = 32, 100
        dst = np.array([[0, 0], [w_, 0], [w_, h_], [0, h_]], np.float64)
        crops, coords = [], []
        for box, score in zip(box_list, score_list):
            if score < args.box_thresh:
                continue
            try:
                matrix = geo.get_perspective_transform(
                    np.asarray(box, np.float64), dst)
            except ValueError:
                continue  # degenerate (collinear) box
            crops.append(geo.warp_perspective(frame[:, :, ::-1], matrix,
                                              (w_, h_)))
            coords.append(np.asarray(box).tolist()[0])
        results = recognize_crops(args, crops, converter, rec_model)
        for coord, result in zip(coords, results):
            cv2.putText(frame, result["pred"],
                        (int(coord[0]), int(coord[1])),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.75, 255, 1)
    return frame


def main(args):
    """``src/test_webcam.py:198-301``: the number of frames read."""
    import cv2

    device = resolve_device(args.device)
    _, forward = build_inference_forward(args.det_model_path,
                                         backbone=args.backbone,
                                         infer_mode=args.infer_mode,
                                         device=device)
    seg_obj = SegDetectorRepresenter(thresh=args.thresh,
                                     box_thresh=args.box_thresh,
                                     unclip_ratio=args.unclip_ratio)
    rec = None
    if args.recognize:
        converter = build_converter(args)
        rec = (converter, load_rec_model(args, len(converter.character)))

    cap = cv2.VideoCapture(args.video_path if args.video_path else 0)
    print(int(cap.get(cv2.CAP_PROP_FPS)))
    out = None
    if args.video_path and args.out_path:
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        out = cv2.VideoWriter(args.out_path, fourcc, 20.0, (640, 480))

    count = 0
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            if args.video_path:
                frame = cv2.resize(frame, (640, 480))
            if count % args.per_frame == 0:
                frame = process_frame(args, frame, forward, seg_obj, rec)
                if args.show_video:
                    cv2.imshow("frame", frame)
                if out is not None:
                    out.write(frame)
            if args.show_video and cv2.waitKey(1) & 0xFF == ord("q"):
                break
            count += 1
            if args.max_frames and count >= args.max_frames:
                break
    finally:
        cap.release()
        if out is not None:
            out.release()
        if args.show_video:
            cv2.destroyAllWindows()
    return count


if __name__ == "__main__":
    main(load_args())
