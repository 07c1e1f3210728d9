"""The port's ``cli/test`` and ``utils/visualize`` against the JAX
package's on the CPU, on the same JAX-written ``.ckpt`` (a narrow detector
with its widths sidecar, its batch statistics the scene's) and the same
image. The JAX overlays are matplotlib figures and the port's are drawn by
cv2, so what is compared is what each figure is drawn from (recorded from
JAX's ``plt.imshow`` and the port's ``overlay``), never the figure's
pixels.

Two runs per mode (heatmap, polygon, rect):

- end to end: the port's forward gives JAX's maps at atol 5e-5 (the repo's
  model parity tolerance); the heatmap's thresholded map is JAX's except
  at pixels whose JAX prob lies within that tolerance of the threshold;
- on JAX's maps (the forward replaced by one returning them): everything
  drawn is JAX's exactly: the thresholded map, ``draw_bbox``'s image, the
  resized prob map, the boxes and scores, and with ``vis_char`` the 32x100
  crops, pixel for pixel (the geometry library is shared).

The int8 mode runs on the port's side: its prob map within a mean of 0.02
of the flax mode's, as ``chip_smoke.py`` holds it on the card."""

import os

import cv2
import numpy as np
import pytest

from db_text_minimal_tpu.cli import test as jtest
from db_text_minimal_tpu.utils import visualize as jvis
from db_text_minimal_tpu_torch.cli import test as ptest
from db_text_minimal_tpu_torch.utils import visualize as pvis
from torch_tools import (ATOL, FakePlt, Recorder, drawn_layers, forward_of,
                         scene_and_ckpt)

MODES = {"heatmap": ["--heatmap", "true"],
         "polygon": ["--is_output_polygon", "true"],
         "rect": ["--is_output_polygon", "false"]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_test")
    s = scene_and_ckpt(str(root))
    prob = s["maps"][0, ..., 0]
    s["prob_thred"] = float(np.percentile(prob, 50))
    s["args"] = ["--image_path", s["image"], "--model_path", s["ckpt"],
                 "--prob_thred", repr(s["prob_thred"]),
                 "--thresh", repr(float(np.percentile(prob, 75))),
                 "--box_thresh", "0.3"]
    return s


def run_jax(setup, mode, out_dir, monkeypatch):
    plt = FakePlt()
    monkeypatch.setattr(jvis, "plt", plt)
    boxes = Recorder(jvis.filter_zero_boxes)
    monkeypatch.setattr(jvis, "filter_zero_boxes", boxes)
    path = jtest.main(jtest.load_args(setup["args"] + MODES[mode]
                                      + ["--save_dir", out_dir]))
    return path, plt.shown, [c[2] for c in boxes.calls]


def run_port(setup, mode, out_dir, monkeypatch, extra=(), maps=None):
    """The port's cli/test; with ``maps`` its forward returns them. Also
    returns the maps its forward gave."""
    drawn = Recorder(pvis.overlay)
    monkeypatch.setattr(pvis, "overlay", drawn)
    boxes = Recorder(pvis.filter_zero_boxes)
    monkeypatch.setattr(pvis, "filter_zero_boxes", boxes)
    build = ptest.build_inference_forward
    forwards = []

    def build_forward(*args, **kwargs):
        model, forward = build(*args, **kwargs)
        forwards.append(Recorder(forward if maps is None
                                 else forward_of(maps)))
        return model, forwards[-1]

    monkeypatch.setattr(ptest, "build_inference_forward", build_forward)
    path = ptest.main(ptest.load_args(
        setup["args"] + MODES[mode] + ["--save_dir", out_dir, "--device",
                                       "cpu", *extra]))
    assert cv2.imread(path) is not None
    preds = forwards[0].calls[0][2].numpy()
    return path, drawn_layers(drawn.calls), [c[2] for c in boxes.calls], \
        preds


def assert_same_boxes(got, ref):
    assert len(got) == len(ref)
    for (gb, gs), (rb, rs) in zip(got, ref):
        assert len(gb) == len(rb)
        for g, r in zip(gb, rb):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(np.asarray(gs), np.asarray(rs))


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_test_matches_jax(setup, mode, tmp_path, monkeypatch):
    ref_path, ref_shown, ref_boxes = run_jax(setup, mode,
                                             str(tmp_path / "jax"),
                                             monkeypatch)
    path, shown, _, preds = run_port(setup, mode, str(tmp_path / "port"),
                                     monkeypatch)
    assert os.path.basename(path) == os.path.basename(ref_path)
    assert os.path.basename(path).startswith(
        {"heatmap": "heatmap_result_", "polygon": "poly_result_",
         "rect": "rect_result_"}[mode])
    np.testing.assert_allclose(preds, setup["maps"], atol=ATOL, rtol=0)
    assert [(c, a) for _, c, a in shown] == [(c, a) for _, c, a in ref_shown]
    if mode == "heatmap":
        np.testing.assert_array_equal(shown[0][0], ref_shown[0][0])
        near = np.abs(setup["maps"][0, ..., 0] - setup["prob_thred"]) <= ATOL
        differ = shown[1][0] != ref_shown[1][0]
        assert not (differ & ~near).any() and near.mean() < 1e-3
    else:
        np.testing.assert_allclose(shown[1][0], ref_shown[1][0], atol=ATOL,
                                   rtol=0)

    # on JAX's maps everything drawn is JAX's
    path, shown, boxes, _ = run_port(setup, mode, str(tmp_path / "same"),
                                     monkeypatch, maps=setup["maps"])
    assert os.path.basename(path) == os.path.basename(ref_path)
    assert len(shown) == len(ref_shown) == 2
    for (got, _, _), (ref, _, _) in zip(shown, ref_shown):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert_same_boxes(boxes, ref_boxes)
    if mode != "heatmap":
        assert len(ref_boxes[0][0]) >= 2


def test_vis_char_crops_match_jax(setup, tmp_path, monkeypatch):
    """``visualize_polygon(vis_char=True)`` in rect mode on the same image
    and maps: the same 32x100 crops in ``./tmp/reconized``. At the 75th
    percentile's threshold one box is a sliver on the image's edge, which
    neither package can warp: both raise."""
    from db_text_minimal_tpu_torch.utils import read_img

    img, h, w = read_img(setup["image"])
    prob = setup["maps"][0, ..., 0]
    crops = {}
    for name, module, cli in (("jax", jvis, jtest), ("port", pvis, ptest)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        if module is jvis:
            monkeypatch.setattr(jvis, "plt", FakePlt())
        args = cli.load_args(setup["args"] + ["--save_dir", str(work)])
        with pytest.raises(ValueError, match="degenerate"):
            module.visualize_polygon(args, "scene.jpg", (img, h, w),
                                     {"shape": [(h, w)]}, setup["maps"],
                                     vis_char=True)
        args.thresh = float(np.percentile(prob, 80))
        module.visualize_polygon(args, "scene.jpg", (img, h, w),
                                 {"shape": [(h, w)]}, setup["maps"],
                                 vis_char=True)
        folder = work / "tmp" / "reconized"
        crops[name] = {f: cv2.imread(str(folder / f))
                       for f in sorted(os.listdir(folder))}
    assert list(crops["port"]) == list(crops["jax"])
    assert len(crops["jax"]) >= 2
    for name, crop in crops["jax"].items():
        assert crop.shape == (32, 100, 3)
        np.testing.assert_array_equal(crops["port"][name], crop)


@pytest.mark.parametrize("mode", ["rect", "heatmap"])
def test_cli_test_int8_mode(setup, mode, tmp_path, monkeypatch):
    """``--infer_mode int8`` (the BN-folded prob-only forward, the wide
    convs int8): the overlay is written and its prob map is within a mean
    0.02 of the flax mode's."""
    _, _, _, flax_preds = run_port(setup, mode, str(tmp_path / "flax"),
                                   monkeypatch)
    path, shown, boxes, preds = run_port(
        setup, mode, str(tmp_path / "int8"), monkeypatch,
        extra=("--infer_mode", "int8"))
    assert preds.shape == flax_preds.shape[:-1] + (1,)
    gap = np.abs(preds[..., 0] - flax_preds[..., 0]).mean()
    assert 0 < gap < 0.02
    assert os.path.exists(path) and len(shown) == 2
    if mode == "rect":
        assert len(boxes[0][0]) >= 1


def test_tensorboard_grids_match_jax():
    """``make_grid`` and ``visualize_tfb``'s three grids, as JAX's."""
    class Writer:
        def __init__(self):
            self.images = []

        def add_image(self, tag, image, step, dataformats):
            self.images.append((tag, np.array(image), step, dataformats))

    rs = np.random.RandomState(5)
    imgs = rs.randint(0, 255, (3, 16, 24, 3)).astype(np.uint8)
    preds = rs.rand(3, 16, 24, 2).astype(np.float32)
    got, ref = Writer(), Writer()
    pvis.visualize_tfb(got, imgs, preds, 11, thresh=0.4, mode="TEST")
    jvis.visualize_tfb(ref, imgs, preds, 11, thresh=0.4, mode="TEST")
    assert [i[0] for i in got.images] == ["TEST/origin_imgs",
                                          "TEST/prob_imgs",
                                          "TEST/thres_imgs"]
    for g, r in zip(got.images, ref.images):
        assert g[0] == r[0] and g[2:] == r[2:]
        assert g[1].dtype == r[1].dtype
        np.testing.assert_array_equal(g[1], r[1])
    np.testing.assert_array_equal(pvis.make_grid(imgs[..., 0], padding=3),
                                  jvis.make_grid(imgs[..., 0], padding=3))


def test_gt_overlay_main_matches_jax(setup, tmp_path, monkeypatch):
    """``python -m ...data.datasets CONFIG`` draws the first shuffled
    training sample's image, prob map and threshold map over each other
    into tmp/foo.jpg; the port unpacks the compact layout's bit-packed
    prob map, which the JAX figure draws packed."""
    import sys

    import matplotlib.pyplot

    from db_text_minimal_tpu.data import datasets as jds
    from db_text_minimal_tpu_torch.data import datasets as pds

    ds = os.path.dirname(os.path.dirname(setup["image"]))
    config = tmp_path / "config.yaml"
    config.write_text(
        f"meta:\n  root_dir: {tmp_path}\ndataset:\n  name: totaltext\n"
        f"data:\n  totaltext:\n    train_dir: {ds}/train_images\n"
        f"    train_gt_dir: {ds}/train_gts\n"
        f"    test_dir: {ds}/test_images\n"
        f"    test_gt_dir: {ds}/test_gts\nhps:\n  img_size: 128\n")
    monkeypatch.setattr(sys, "argv", ["datasets", str(config)])
    plt = FakePlt()
    monkeypatch.setattr(matplotlib.pyplot, "imshow", plt.imshow)
    monkeypatch.setattr(matplotlib.pyplot, "savefig", plt.savefig)
    jds._visualize_sample_main()
    drawn = Recorder(pvis.overlay)
    monkeypatch.setattr(pvis, "overlay", drawn)
    out = pds._visualize_sample_main()
    assert out == str(tmp_path / "tmp" / "foo.jpg") == plt.saved[0]
    assert cv2.imread(out).shape == (128, 128, 3)
    shown = drawn_layers(drawn.calls)
    assert [(c, a) for _, c, a in shown] == [(c, a) for _, c, a in plt.shown]
    np.testing.assert_array_equal(shown[0][0], plt.shown[0][0])
    np.testing.assert_array_equal(shown[1][0],
                                  np.unpackbits(plt.shown[1][0], axis=-1))
    assert shown[1][0].sum() > 0
    np.testing.assert_array_equal(shown[2][0], plt.shown[2][0])


@pytest.mark.parametrize("mode", ["heatmap", "rect"])
def test_cli_test_takes_a_loaded_forward(setup, mode, tmp_path,
                                         monkeypatch):
    """``main(args, forward)``, the counterpart of JAX's ``main(args, net,
    variables)``: a forward loaded once gives the overlay that the
    load-per-call path writes on the same image, pixel for pixel, and no
    model is loaded."""
    args = setup["args"] + MODES[mode] + ["--device", "cpu"]
    ref = ptest.main(ptest.load_args(
        args + ["--save_dir", str(tmp_path / "load")]))
    _, forward = ptest.build_inference_forward(setup["ckpt"], device="cpu")

    def refuse(*a, **k):
        raise AssertionError("main loaded a model though given a forward")

    monkeypatch.setattr(ptest, "build_inference_forward", refuse)
    for _ in range(2):
        got = ptest.main(ptest.load_args(
            args + ["--save_dir", str(tmp_path / "given")]), forward)
        assert os.path.basename(got) == os.path.basename(ref)
        np.testing.assert_array_equal(cv2.imread(got), cv2.imread(ref))
