"""Single-image inference CLI: heatmap, polygon or rect overlay.

Port of ``db_text_minimal_tpu/cli/test.py`` (the reference's
``src/test.py``): the detector of ``--model_path`` (a ``.pth``, a port
checkpoint or a JAX Flax ``.ckpt``) runs on one image through
``build_inference_forward`` in the ``--infer_mode`` (flax, folded or int8)
on ``--device``, CUDA by default, or through a forward loaded once and
passed in (``main(args, forward)``); the overlay goes to ``--save_dir``.

Usage::

    python -m db_text_minimal_tpu_torch.cli.test --image_path img.jpg \\
        --model_path models/best_cp.ckpt --is_output_polygon true \\
        [--heatmap true] [--infer_mode int8] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

from ..utils import read_img, test_preprocess
from ..utils.visualize import visualize_heatmap, visualize_polygon
from .common import add_inference_args, build_inference_forward


def load_args(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    add_inference_args(parser)
    return parser.parse_args(argv)


def main(args, forward=None):
    """``src/test.py:45-67``: the path of the overlay written.
    ``forward`` is a loaded forward as ``build_inference_forward`` returns
    it, the counterpart of JAX's ``net`` and ``variables``: with it no
    model is loaded, and ``--model_path``, ``--backbone``,
    ``--infer_mode`` and ``--device`` are not read."""
    if forward is None:
        _, forward = build_inference_forward(
            args.model_path, backbone=args.backbone,
            infer_mode=args.infer_mode, device=args.device)
    img_path = args.image_path.replace("file://", "")
    img_fn = img_path.split("/")[-1]
    img_origin, h_origin, w_origin = read_img(img_path)
    tmp_img = test_preprocess(img_origin, pad=False)

    start = time.time()
    preds = forward(tmp_img).float().cpu().numpy()
    print(">>> Inference took {}'s".format(time.time() - start))

    os.makedirs(args.save_dir, exist_ok=True)
    if args.heatmap:
        return visualize_heatmap(args, img_fn, tmp_img[0], preds[0])
    batch = {"shape": [(h_origin, w_origin)]}
    return visualize_polygon(args, img_fn, (img_origin, h_origin, w_origin),
                             batch, preds)


if __name__ == "__main__":
    main(load_args())
