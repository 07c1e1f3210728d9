"""The port's OCR path against the JAX package's on the CPU: the geometry
wrappers of the warp, ``cli.ocr`` (one image and the folder mode) and
``cli.rec_bench`` (``--mode rec`` and ``--mode e2e``) on the same detector
``.pth`` and the same recognizer weights (JAX's checkpoint written by JAX's
``save_checkpoint``, the port's carried by ``rec_state_dict_from_jax``),
``distort_crop`` and ``_warp_crop``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu.ops import geometry as jgeo
from db_text_minimal_tpu_torch.ops import geometry as geo
from torch_rec import jax_init

torch.set_num_threads(1)

REC = ["--Transformation", "None", "--FeatureExtraction", "VGG",
       "--SequenceModeling", "BiLSTM", "--Prediction", "Attn",
       "--output_channel", "32", "--hidden_size", "16"]


def test_geometry_wrappers_match_jax():
    rs = np.random.RandomState(0)
    for n in (3, 7, 40):
        pts = rs.rand(n, 2) * 100
        np.testing.assert_array_equal(geo.convex_hull(pts),
                                      jgeo.convex_hull(pts))
    dst = np.array([[0, 0], [100, 0], [100, 32], [0, 32]], np.float64)
    img = (rs.rand(60, 80, 3) * 255).astype(np.uint8)
    for _ in range(5):
        src = np.array([[5, 5], [70, 8], [72, 40], [4, 44]],
                       np.float64) + rs.uniform(-4, 4, (4, 2))
        m = geo.get_perspective_transform(src, dst)
        np.testing.assert_array_equal(m, jgeo.get_perspective_transform(
            src, dst))
        np.testing.assert_array_equal(geo.warp_perspective(img, m, (100, 32)),
                                      jgeo.warp_perspective(img, m, (100, 32)))
        np.testing.assert_array_equal(
            geo.warp_perspective(img[..., 0], m, (100, 32)),
            jgeo.warp_perspective(img[..., 0], m, (100, 32)))
    line = np.array([[0, 0], [1, 1], [2, 2], [3, 3]], np.float64)
    for module in (geo, jgeo):
        with pytest.raises(ValueError):
            module.get_perspective_transform(line, dst)


@pytest.fixture(scope="module")
def ocr_setup(tmp_path_factory):
    """A glyph set, a detector ``.pth`` whose head is damped so its prob
    map is not saturated (random weights), thresholds at percentiles of
    that map, and the recognizer's checkpoints in both formats."""
    from db_text_minimal_tpu.models.recognition import RecognitionModel
    from db_text_minimal_tpu.train.checkpoints import \
        save_checkpoint as jsave
    from db_text_minimal_tpu_torch.data.synthetic import generate_glyphs
    from db_text_minimal_tpu_torch.models import DBTextModel
    from db_text_minimal_tpu_torch.train.checkpoints import save_checkpoint
    from db_text_minimal_tpu_torch.utils import read_img, test_preprocess
    from db_text_minimal_tpu_torch.weights import rec_state_dict_from_jax

    root = tmp_path_factory.mktemp("ocr")
    section = generate_glyphs(str(root / "glyph"), n_train=1, n_test=2,
                              size=256, seed=8)
    det = DBTextModel()
    det.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        det.segmentation_head.binarize[6].weight.mul_(1e-4)
        det.segmentation_head.binarize[6].bias.zero_()
    det_path = str(root / "det.pth")
    torch.save(det.state_dict(), det_path)
    image = os.path.join(section["test_dir"], "img1001.jpg")
    with torch.no_grad():
        prob = det.eval()(torch.from_numpy(test_preprocess(
            read_img(image)[0])))[..., 0].numpy()

    jm = RecognitionModel(num_class=38, feature_extraction="VGG",
                          prediction="Attn", output_channel=32,
                          hidden_size=16)
    v = jax_init(jm, jnp.zeros((1, 32, 100, 1)),
                 text=jnp.zeros((1, 27), jnp.int32), seed=3)
    # make [s] rare, so the strings are not all empty
    v["params"]["prediction"]["generator"]["bias"][1] -= 3.0
    jax_ckpt = str(root / "rec_jax.ckpt")
    jsave(jax_ckpt, {"params": v["params"], "batch_stats": v["batch_stats"]})
    port_ckpt = str(root / "rec_port.ckpt")
    save_checkpoint(port_ckpt, {"model": rec_state_dict_from_jax(
        v["params"], v["batch_stats"])})
    thresh = ["--thresh", f"{np.percentile(prob, 70):.6f}",
              "--box_thresh", f"{np.percentile(prob, 50):.6f}"]
    return {"root": root, "data": str(root / "glyph"), "image": image,
            "det": det_path, "jax": jax_ckpt, "port": port_ckpt,
            "thresh": thresh}


def _run_ocr(cli, setup, ckpt, extra, tmp_path, name, monkeypatch):
    work = tmp_path / name
    work.mkdir()
    monkeypatch.chdir(work)
    return cli.main(cli.load_args(
        ["--det_model_path", setup["det"], "--saved_model", ckpt,
         "--out_path", str(work / "out.jpg")] + REC + extra))


def test_ocr_main_matches_jax(ocr_setup, tmp_path, monkeypatch):
    """One image: the same boxes, crops, strings and scores, and the same
    drawn output image."""
    from db_text_minimal_tpu.cli import ocr as jocr
    from db_text_minimal_tpu_torch.cli import ocr

    extra = ["--img_path", ocr_setup["image"]] + ocr_setup["thresh"]
    ref = _run_ocr(jocr, ocr_setup, ocr_setup["jax"], extra, tmp_path,
                   "jax", monkeypatch)
    got = _run_ocr(ocr, ocr_setup, ocr_setup["port"],
                   extra + ["--device", "cpu"], tmp_path, "port",
                   monkeypatch)
    assert len(got) >= 2 and any(r["pred"] for r in got)
    assert [r["box"] for r in got] == [r["box"] for r in ref]
    assert [r["pred"] for r in got] == [r["pred"] for r in ref]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in ref], atol=1e-5)
    import cv2

    for name in sorted(os.listdir(tmp_path / "jax" / "tmp" / "reconized")):
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / "port" / "tmp" / "reconized" / name)),
            cv2.imread(str(tmp_path / "jax" / "tmp" / "reconized" / name)))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" /
                                                 "out.jpg")),
                                  cv2.imread(str(tmp_path / "jax" /
                                                 "out.jpg")))


def test_ocr_folder_mode_matches_jax(ocr_setup, tmp_path):
    from db_text_minimal_tpu.cli import ocr as jocr
    from db_text_minimal_tpu_torch.cli import ocr

    folder = os.path.join(ocr_setup["data"], "test_images")
    args = ["--img_folder", folder, "--saved_model"]
    ref = jocr.main(jocr.load_args(args + [ocr_setup["jax"]] + REC))
    got = ocr.main(ocr.load_args(args + [ocr_setup["port"], "--device",
                                         "cpu"] + REC))
    assert [fp for fp, _ in got] == [fp for fp, _ in ref] and len(got) == 2
    assert [r["pred"] for _, r in got] == [r["pred"] for _, r in ref]
    np.testing.assert_allclose([r["score"] for _, r in got],
                               [r["score"] for _, r in ref], atol=1e-5)


@pytest.mark.parametrize("mode", ["rec", "e2e"])
def test_rec_bench_matches_jax(ocr_setup, tmp_path, mode):
    """The same report as the JAX package's. The e2e detector is the
    damped random one, so its boxes are matched at IoU >= 0.01: the
    numbers check the path, not a detector."""
    from db_text_minimal_tpu.cli import rec_bench as jbench
    from db_text_minimal_tpu_torch.cli import rec_bench

    args = ["--mode", mode, "--data_dir", ocr_setup["data"]] + REC
    if mode == "e2e":
        args += ["--det_model_path", ocr_setup["det"], "--iou_match", "0.01"]
        args += ocr_setup["thresh"]
    ref = jbench.main(jbench.load_args(
        args + ["--saved_model", ocr_setup["jax"], "--out",
                str(tmp_path / "jax.json")]))
    got = rec_bench.main(rec_bench.load_args(
        args + ["--saved_model", ocr_setup["port"], "--out",
                str(tmp_path / "port.json"), "--device", "cpu"]))
    if mode == "rec":
        assert got["total"] > 4
        assert abs(got["mean_confidence"] - ref["mean_confidence"]) <= 1e-4
        got.pop("mean_confidence"), ref.pop("mean_confidence")
    else:
        assert got["n_detections"] > 0 and got["det_recall"] > 0
    assert got == ref


def test_predict_chunked_is_per_crop(ocr_setup):
    """Chunks of 3 over 7 crops, the last one short (JAX pads it to the
    chunk size): the same results as one crop a forward."""
    from db_text_minimal_tpu_torch.cli import rec_bench
    from db_text_minimal_tpu_torch.cli.ocr import build_converter
    from db_text_minimal_tpu_torch.models.recognition import predict

    args = rec_bench.load_args(
        ["--mode", "rec", "--data_dir", "x", "--out", "y", "--saved_model",
         ocr_setup["port"], "--device", "cpu"] + REC)
    converter = build_converter(args)
    from db_text_minimal_tpu_torch.cli.ocr import load_rec_model

    model = load_rec_model(args, len(converter.character))
    rs = np.random.RandomState(9)
    xs = [rs.rand(1, 32, 100, 1).astype(np.float32) * 2 - 1
          for _ in range(7)]
    chunked = rec_bench._predict_chunked(xs, converter, model, args,
                                         batch=3)
    assert len(chunked) == 7
    for x, res in zip(xs, chunked):
        single = predict(x, converter, model, prediction="Attn",
                         batch_max_length=25)
        assert res["pred"] == single["pred"]
        assert res["score"] == pytest.approx(single["score"], abs=1e-6)


def test_distort_crop_matches_jax():
    from db_text_minimal_tpu.cli.rec_bench import distort_crop as jdistort
    from db_text_minimal_tpu_torch.cli.rec_bench import distort_crop

    crop = (np.random.default_rng(7).random((32, 100, 3)) * 255).astype(
        np.uint8)
    for seed in (0, 42, 1234):
        got = distort_crop(crop, np.random.default_rng(seed))
        np.testing.assert_array_equal(
            got, jdistort(crop, np.random.default_rng(seed)))
        assert np.abs(got.astype(float) - crop).mean() > 10


def test_warp_crop_nonquad_orientation():
    """Curved-GT rectification orders the min-area-rect corners: the same
    rotated rect as a 4-point quad and as an 8-point polygon (corners and
    edge midpoints) warps to the same upright crop, and to the JAX
    package's crop."""
    from db_text_minimal_tpu.cli.rec_bench import _warp_crop as jwarp
    from db_text_minimal_tpu_torch.cli.rec_bench import _warp_crop
    from db_text_minimal_tpu_torch.postprocess import order_rect_points

    # smooth asymmetric image: any rotation of the crop changes it a lot
    yy, xx = np.mgrid[0:120, 0:160]
    img = np.stack([xx * 1.5, yy * 2.0, xx * 0.5 + yy], -1).astype(np.uint8)

    for angle_deg in (10, 55, 100, 160, 250):
        a = np.deg2rad(angle_deg)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        base = np.array([[-30, -10], [30, -10], [30, 10], [-30, 10]],
                        np.float64)
        quad = base @ rot.T + np.array([80, 60])
        quad_ordered = np.asarray(order_rect_points(quad), np.float64)
        mids = (quad + np.roll(quad, -1, axis=0)) / 2
        poly8 = np.empty((8, 2), np.float64)
        poly8[0::2] = quad
        poly8[1::2] = mids

        crop_quad = _warp_crop(img, quad_ordered)
        crop_poly = _warp_crop(img, poly8)
        diff = np.abs(crop_quad.astype(float) - crop_poly.astype(float))
        assert diff.mean() < 3.0, (angle_deg, diff.mean())
        np.testing.assert_array_equal(crop_poly, jwarp(img, poly8))
