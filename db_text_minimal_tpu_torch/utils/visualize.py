"""Visualization: heatmap, polygon and rect overlays, and TensorBoard grids.

Counterpart of ``db_text_minimal_tpu/utils/visualize.py``: ``make_grid``,
``visualize_tfb``, ``visualize_heatmap`` and ``visualize_polygon`` (with
the 32x100 word crops of ``vis_char``), under the same file names. The JAX
package draws its overlays with matplotlib; the port draws them with cv2
(``overlay``: the map scaled over its own range, coloured by cv2's jet or
inferno map and blended over the image at ``alpha``) at the image's own
size, so it needs no plotting package.
"""

from __future__ import annotations

import os

import numpy as np

from . import draw_bbox, filter_zero_boxes, minmax_scaler_img

CROP_DIR = "./tmp/reconized"


def make_grid(images: np.ndarray, padding: int = 2) -> np.ndarray:
    """torchvision's ``make_grid`` for NHWC (or NHW) arrays, in one row."""
    n, h, w = images.shape[:3]
    c = images.shape[3] if images.ndim == 4 else 1
    imgs = images.reshape(n, h, w, c)
    grid = np.zeros((h + 2 * padding, n * (w + padding) + padding, c),
                    imgs.dtype)
    for i, im in enumerate(imgs):
        x0 = padding + i * (w + padding)
        grid[padding:padding + h, x0:x0 + w] = im
    return grid


def visualize_tfb(tfb_writer, imgs, preds, global_steps: int,
                  thresh: float = 0.5, mode: str = "TRAIN") -> None:
    """Three image grids for TensorBoard: the images scaled to uint8, the
    prob maps over ``thresh`` and the threshold maps. ``imgs`` and
    ``preds`` are NHWC arrays."""
    imgs = np.asarray(imgs)
    preds = np.asarray(preds)
    origin = np.stack([minmax_scaler_img(im) for im in imgs])
    tfb_writer.add_image(f"{mode}/origin_imgs", make_grid(origin),
                         global_steps, dataformats="HWC")
    prob = (preds[..., 0] > thresh).astype(np.float32)[..., None]
    thr = preds[..., 1][..., None]
    tfb_writer.add_image(f"{mode}/prob_imgs", make_grid(prob, padding=0),
                         global_steps, dataformats="HWC")
    tfb_writer.add_image(f"{mode}/thres_imgs", make_grid(thr, padding=0),
                         global_steps, dataformats="HWC")


def overlay(image: np.ndarray, layers, path: str) -> str:
    """Write the RGB uint8 ``image`` with each ``(map, colormap, alpha)``
    of ``layers`` blended over it in turn to ``path``. A map is scaled over
    its own range (all 0 when flat) and coloured by cv2's ``colormap``
    ("jet" or "inferno"); a map of another size is resized to the
    image's."""
    import cv2

    maps = {"jet": cv2.COLORMAP_JET, "inferno": cv2.COLORMAP_INFERNO}
    out = np.ascontiguousarray(image[:, :, ::-1]).astype(np.float32)
    for value, cmap, alpha in layers:
        scaled = minmax_scaler_img(np.asarray(value, np.float32))
        if scaled.shape != image.shape[:2]:
            scaled = cv2.resize(scaled, (image.shape[1], image.shape[0]),
                                interpolation=cv2.INTER_NEAREST)
        color = cv2.applyColorMap(scaled, maps[cmap]).astype(np.float32)
        out = (1 - alpha) * out + alpha * color
    if not cv2.imwrite(path, np.clip(out + 0.5, 0, 255).astype(np.uint8)):
        raise OSError(f"cv2 could not write {path}")
    return path


def visualize_heatmap(args, img_fn: str, tmp_img: np.ndarray,
                      tmp_pred: np.ndarray) -> str:
    """The prob map over ``args.prob_thred``, in jet at ``args.alpha``,
    over the preprocessed image; written to
    ``<save_dir>/heatmap_result_<img_fn>``."""
    pred_prob = tmp_pred[..., 0] if tmp_pred.ndim == 3 else tmp_pred
    pred_prob = (pred_prob > args.prob_thred).astype(np.float32)
    np_img = minmax_scaler_img(np.asarray(tmp_img))
    return overlay(np_img, [(pred_prob, "jet", args.alpha)],
                   os.path.join(args.save_dir,
                                "heatmap_result_{}".format(img_fn)))


def visualize_polygon(args, img_fn: str, origin_info, batch, preds,
                      seg_obj=None, vis_char: bool = False) -> str:
    """The boxes (rect mode) or polygons of ``preds`` drawn on the original
    image with the prob map, resized to it, in inferno at ``args.alpha``;
    written to ``<save_dir>/{poly,rect}_result_<img_fn>``. With
    ``vis_char`` in rect mode, each box is also warped to a 32x100 crop
    in ``./tmp/reconized`` (``word_<i>.jpg``), which is emptied first."""
    import cv2

    from ..ops import geometry as geo
    from ..postprocess import SegDetectorRepresenter

    img_origin, h_origin, w_origin = origin_info
    if seg_obj is None:
        seg_obj = SegDetectorRepresenter(thresh=args.thresh,
                                         box_thresh=args.box_thresh,
                                         unclip_ratio=args.unclip_ratio)
    box_list, score_list = seg_obj(batch, preds,
                                   is_output_polygon=args.is_output_polygon)
    box_list, score_list = filter_zero_boxes(box_list[0], score_list[0],
                                             args.is_output_polygon)

    # polygons may have different vertex counts: draw_bbox takes the list
    tmp_img = draw_bbox(np.ascontiguousarray(img_origin), box_list)
    tmp_pred = cv2.resize(np.asarray(preds)[0, :, :, 0],
                          (w_origin, h_origin))

    if not args.is_output_polygon and vis_char:
        os.makedirs(CROP_DIR, exist_ok=True)
        for f in os.listdir(CROP_DIR):
            os.remove(os.path.join(CROP_DIR, f))
        h_, w_ = 32, 100
        dst = np.array([[0, 0], [w_, 0], [w_, h_], [0, h_]], np.float64)
        for index, box in enumerate(box_list):
            src = np.asarray(box, np.float64)
            matrix = geo.get_perspective_transform(src, dst)
            warp = geo.warp_perspective(img_origin, matrix, (w_, h_))
            cv2.imwrite(os.path.join(CROP_DIR, "word_{}.jpg".format(index)),
                        warp[:, :, ::-1])

    prefix = "poly" if args.is_output_polygon else "rect"
    return overlay(tmp_img, [(tmp_pred, "inferno", args.alpha)],
                   os.path.join(args.save_dir,
                                "{}_result_{}".format(prefix, img_fn)))
