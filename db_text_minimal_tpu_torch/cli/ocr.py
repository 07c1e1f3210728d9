"""Full OCR pipeline CLI: detect -> perspective-crop -> recognize -> overlay.

Port of ``db_text_minimal_tpu/cli/ocr.py`` (the reference's
``src/test_ocr.py``) with the port's recognizer (``models/recognition``).
The detector runs through ``build_inference_forward`` (``--infer_mode
flax|folded|int8``), its prob map goes through the host
``SegDetectorRepresenter`` in rect mode, each box is warped to 32x100 by the
geometry library (``get_perspective_transform``, ``warp_perspective``) and
written to ``./tmp/reconized``, and each crop is recognized in its own
forward, as in JAX. Both models run on ``--device``, CUDA by default; the
recognizer in float32 with TF32 off. With no recognition checkpoint the
recognizer is at its seeded random init (seed 0).

Usage::

    python -m db_text_minimal_tpu_torch.cli.ocr --img_path img.jpg \\
        --det_model_path models/best_cp.ckpt --saved_model models/rec.ckpt \\
        --Transformation None --FeatureExtraction ResNet \\
        --SequenceModeling BiLSTM --Prediction Attn [--infer_mode int8]
"""

from __future__ import annotations

import argparse
import glob
import os
import string
import time

import numpy as np
import torch

from ..models.recognition import (AttnLabelConverter, CTCLabelConverter,
                                  RecognitionModel, predict, rec_preprocess)
from ..ops import geometry as geo
from ..postprocess import SegDetectorRepresenter
from ..train.checkpoints import load_params_any
from ..utils import (draw_bbox, filter_zero_boxes, read_img, resolve_device,
                     test_preprocess)
from .common import _fp32_convolutions, build_inference_forward, make_forward


def build_converter(opt):
    if "CTC" in opt.Prediction:
        return CTCLabelConverter(opt.character)
    return AttnLabelConverter(opt.character)


def load_rec_model(opt, num_class: int) -> RecognitionModel:
    """The recognizer of ``opt``'s stages on ``opt.device`` in eval mode,
    from ``opt.saved_model`` or at its seeded init (seed 0)."""
    device = resolve_device(opt.device)
    _fp32_convolutions()
    model = RecognitionModel(
        num_class=num_class,
        transformation=opt.Transformation,
        feature_extraction=opt.FeatureExtraction,
        sequence_modeling=opt.SequenceModeling,
        prediction=opt.Prediction,
        hidden_size=opt.hidden_size,
        output_channel=opt.output_channel,
        num_fiducial=opt.num_fiducial,
        batch_max_length=opt.batch_max_length,
        input_channel=opt.input_channel)
    if opt.saved_model and os.path.exists(opt.saved_model):
        print(">>> loading pretrained model from {}".format(opt.saved_model))
        model.load_state_dict(load_params_any(opt.saved_model), strict=True)
    else:
        print(">>> no recognition checkpoint; using random init")
        model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device).flatten_parameters().eval()


def recognize_crops(opt, crops, converter, rec_model):
    """Recognize each RGB word crop of ``crops`` in its own forward."""
    results = []
    for crop in crops:
        tensors = rec_preprocess(crop, img_h=opt.imgH, img_w=opt.imgW,
                                 pad=opt.PAD)
        start = time.time()
        result = predict(tensors, converter, rec_model,
                         prediction=opt.Prediction,
                         batch_max_length=opt.batch_max_length)
        if opt.debug:
            print(">>> Recognize: {}".format(time.time() - start), result)
        results.append(result)
    return results


def detect_and_crop(opt, dbnet, img_origin, h_origin, w_origin,
                    forward=None):
    """Detect rect boxes and warp each to 32x100 (``src/test_ocr.py:
    121-177``): (box list, [(first corner, crop), ...])."""
    if forward is None:
        forward = make_forward(dbnet)
    tmp_img = test_preprocess(img_origin, pad=False)
    start = time.time()
    preds = forward(tmp_img).float().cpu().numpy()
    print(">>> Detect: {}'s".format(time.time() - start))

    seg_obj = SegDetectorRepresenter(thresh=opt.thresh,
                                     box_thresh=opt.box_thresh,
                                     unclip_ratio=opt.unclip_ratio)
    batch = {"shape": [(h_origin, w_origin)]}
    box_list, score_list = seg_obj(batch, preds,
                                   is_output_polygon=opt.is_output_polygon)
    box_list, score_list = filter_zero_boxes(box_list[0], score_list[0],
                                             opt.is_output_polygon)
    h_, w_ = 32, 100
    dst = np.array([[0, 0], [w_, 0], [w_, h_], [0, h_]], np.float64)
    img_warps = []
    if not opt.is_output_polygon:
        import cv2

        os.makedirs("./tmp/reconized", exist_ok=True)
        for f in glob.glob("./tmp/reconized/*"):
            os.remove(f)
        for index, box in enumerate(box_list):
            src = np.asarray(box, np.float64)
            try:
                matrix = geo.get_perspective_transform(src, dst)
            except ValueError:
                continue  # degenerate (collinear) box: nothing to rectify
            warp = geo.warp_perspective(img_origin, matrix, (w_, h_))
            cv2.imwrite("./tmp/reconized/word_{}.jpg".format(index),
                        warp[:, :, ::-1])
            img_warps.append((np.asarray(box).tolist()[0], warp))
    return box_list, img_warps


def main(opt):
    """``src/test_ocr.py:111-210``: the results, one
    ``{"box", "pred", "score"}`` per recognized box (the folder mode: one
    ``(path, result)`` per image)."""
    import cv2

    device = resolve_device(opt.device)
    print(">>> Device: {}".format(device))
    converter = build_converter(opt)
    num_class = len(converter.character)
    print(">>> no class: {}".format(num_class))
    rec_model = load_rec_model(opt, num_class)

    if opt.img_folder:  # make test-folder: recognize pre-cropped images
        results = []
        for fp in sorted(glob.glob(os.path.join(opt.img_folder, "*"))):
            img, _, _ = read_img(fp)
            res = recognize_crops(opt, [img], converter, rec_model)[0]
            print(fp, res)
            results.append((fp, res))
        return results

    dbnet, det_fwd = build_inference_forward(
        opt.det_model_path, backbone=opt.backbone,
        infer_mode=opt.infer_mode, device=device)
    img_path = opt.img_path.replace("file://", "")
    img_origin, h_origin, w_origin = read_img(img_path)
    box_list, img_warps = detect_and_crop(opt, dbnet, img_origin, h_origin,
                                          w_origin, forward=det_fwd)
    img_out = np.ascontiguousarray(
        draw_bbox(img_origin, np.array(box_list), color=(0, 0, 255),
                  thickness=1).astype(np.uint8))

    results = []
    crops = [warp for _, warp in img_warps]
    recs = recognize_crops(opt, crops, converter, rec_model)
    for (coord, _), result in zip(img_warps, recs):
        x, y = int(coord[0]), int(coord[1])
        cv2.circle(img_out, (x, y), radius=0, color=(0, 255, 0),
                   thickness=max(int(h_origin * 0.01), 1))
        cv2.putText(img_out, result["pred"], (x, y),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.75, 255, 2)
        results.append({"box": coord, **result})

    if opt.out_path:
        os.makedirs(os.path.dirname(opt.out_path) or ".", exist_ok=True)
        cv2.imwrite(opt.out_path, img_out[:, :, ::-1])
    return results


def load_args(argv=None):
    """``src/test_ocr.py:213-303``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--webcam", required=False)
    parser.add_argument("--img_path", required=False)
    parser.add_argument("--img_folder", required=False)
    parser.add_argument("--out_path", required=False)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--is_output_polygon", action="store_true")
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--saved_model", required=False, default=None)
    parser.add_argument("--infer_mode", type=str, default="flax",
                        choices=("flax", "folded", "int8"),
                        help="detector forward: the plain model, or the "
                             "BN-folded / int8 prob-only forward of the "
                             "flagship configuration")
    parser.add_argument("--det_model_path", type=str,
                        default="./models/best_cp.ckpt")
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--thresh", type=float, default=0.25)
    parser.add_argument("--box_thresh", type=float, default=0.50)
    parser.add_argument("--unclip_ratio", type=float, default=1.5)
    parser.add_argument("--alpha", type=float, default=0.6)
    parser.add_argument("--batch_max_length", type=int, default=25)
    parser.add_argument("--imgH", type=int, default=32)
    parser.add_argument("--imgW", type=int, default=100)
    parser.add_argument("--rgb", action="store_true")
    parser.add_argument("--character", type=str,
                        default="0123456789abcdefghijklmnopqrstuvwxyz")
    parser.add_argument("--sensitive", action="store_true")
    parser.add_argument("--PAD", action="store_true")
    parser.add_argument("--Transformation", type=str, default="None",
                        choices=["None", "TPS"])
    parser.add_argument("--FeatureExtraction", type=str, default="ResNet",
                        choices=["VGG", "RCNN", "ResNet"])
    parser.add_argument("--SequenceModeling", type=str, default="BiLSTM",
                        choices=["None", "BiLSTM"])
    parser.add_argument("--Prediction", type=str, default="Attn",
                        choices=["CTC", "Attn"])
    parser.add_argument("--num_fiducial", type=int, default=20)
    parser.add_argument("--input_channel", type=int, default=1)
    parser.add_argument("--output_channel", type=int, default=512)
    parser.add_argument("--hidden_size", type=int, default=256)
    opt = parser.parse_args(argv)
    if opt.sensitive:
        opt.character = string.printable[:-6]
    if opt.rgb:
        opt.input_channel = 3
    return opt


if __name__ == "__main__":
    main(load_args())
