"""The port's ``cli/webcam`` against the JAX package's on the CPU, on a
video file (mp4v, as the CLI writes it) of a synthetic scene, the same
JAX-written detector ``.ckpt`` (narrow, its widths sidecar beside it) and
the same JAX-written recognizer ``.ckpt``, which the port reads through its
Flax reader.

- ``main`` end to end: the same number of frames read, one output frame
  written a processed frame, and each processed frame's maps the JAX
  forward's at atol 5e-5 (the repo's model parity tolerance);
- ``process_frame`` on JAX's maps of each frame (the forward replaced by
  one returning them), with and without recognition: the same boxes and
  scores, the same words (confidences at atol 1e-5, the OCR tests'), and
  the same annotated frame, pixel for pixel.

``--show_video`` needs a display, which the test machines lack: it is not
tested."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from db_text_minimal_tpu.cli import webcam as jwebcam
from db_text_minimal_tpu.models.recognition import RecognitionModel
from db_text_minimal_tpu.train.checkpoints import \
    save_checkpoint as jax_save_checkpoint
from db_text_minimal_tpu_torch.cli import webcam
from torch_rec import jax_init
from torch_tools import ATOL, Recorder, forward_of, scene_and_ckpt

FRAMES = 4
REC = ["--Transformation", "None", "--FeatureExtraction", "VGG",
       "--SequenceModeling", "BiLSTM", "--Prediction", "Attn",
       "--output_channel", "32", "--hidden_size", "16"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The scene's detector, a 4-frame 640x480 video of the scene shifted
    a few pixels a frame, and a recognizer checkpoint written by JAX."""
    root = tmp_path_factory.mktemp("webcam")
    s = scene_and_ckpt(str(root))
    scene = cv2.resize(cv2.imread(s["image"]), (640, 480))
    video = str(root / "in.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (640, 480))
    for i in range(FRAMES):
        writer.write(np.roll(scene, 3 * i, axis=1))
    writer.release()
    model = RecognitionModel(num_class=38, feature_extraction="VGG",
                             prediction="Attn", output_channel=32,
                             hidden_size=16)
    v = jax_init(model, jnp.zeros((1, 32, 100, 1)),
                 text=jnp.zeros((1, 27), jnp.int32), seed=3)
    # make [s] rare, so the strings are not all empty
    v["params"]["prediction"]["generator"]["bias"][1] -= 3.0
    rec = str(root / "rec.ckpt")
    jax_save_checkpoint(rec, {"params": v["params"],
                              "batch_stats": v["batch_stats"]})
    prob = s["maps"][0, ..., 0]
    s.update(video=video, rec=rec, args=[
        "--det_model_path", s["ckpt"], "--video_path", video,
        "--thresh", repr(float(np.percentile(prob, 80))),
        "--box_thresh", "0.3", "--saved_model", rec] + REC)
    return s


def test_webcam_main_matches_jax(setup, tmp_path, monkeypatch):
    maps = {}
    for name, module, extra in (("jax", jwebcam, []),
                                ("port", webcam, ["--device", "cpu"])):
        build = module.build_inference_forward
        forwards = []

        def build_forward(*args, _build=build, _forwards=forwards,
                          **kwargs):
            *rest, forward = _build(*args, **kwargs)
            _forwards.append(Recorder(forward))
            return (*rest, _forwards[-1])

        monkeypatch.setattr(module, "build_inference_forward", build_forward)
        out = str(tmp_path / f"{name}.mp4")
        count = module.main(module.load_args(
            setup["args"] + ["--out_path", out, "--per_frame", "2",
                             "--recognize"] + extra))
        assert count == FRAMES
        cap = cv2.VideoCapture(out)
        written = 0
        while cap.read()[0]:
            written += 1
        cap.release()
        assert written == FRAMES // 2
        maps[name] = [np.asarray(c[2]) for c in forwards[0].calls]
    assert len(maps["port"]) == len(maps["jax"]) == FRAMES // 2
    for got, ref in zip(maps["port"], maps["jax"]):
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("recognize", [False, True])
def test_process_frame_matches_jax(setup, recognize, monkeypatch):
    from db_text_minimal_tpu.cli.common import \
        build_inference_forward as jax_build
    from db_text_minimal_tpu.cli.ocr import (build_converter as jconverter,
                                             load_rec_model as jrec_model)
    from db_text_minimal_tpu.postprocess import \
        SegDetectorRepresenter as JaxRepresenter
    from db_text_minimal_tpu_torch.cli.ocr import (build_converter,
                                                   load_rec_model)
    from db_text_minimal_tpu_torch.postprocess import SegDetectorRepresenter

    flags = setup["args"] + (["--recognize"] if recognize else [])
    jargs = jwebcam.load_args(flags)
    args = webcam.load_args(flags + ["--device", "cpu"])
    _, det_vars, jforward = jax_build(setup["ckpt"])
    jrec = prec = None
    if recognize:
        conv = jconverter(jargs)
        jrec = (conv, *jrec_model(jargs, len(conv.character)))
        conv = build_converter(args)
        prec = (conv, load_rec_model(args, len(conv.character)))
    records = {}
    for name, module in (("jax", jwebcam), ("port", webcam)):
        records[name] = (Recorder(module.filter_zero_boxes),
                         Recorder(module.recognize_crops))
        monkeypatch.setattr(module, "filter_zero_boxes", records[name][0])
        monkeypatch.setattr(module, "recognize_crops", records[name][1])
    thresholds = dict(thresh=args.thresh, box_thresh=args.box_thresh,
                      unclip_ratio=args.unclip_ratio)
    cap = cv2.VideoCapture(setup["video"])
    frames = 0
    words = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frame = cv2.resize(frame, (640, 480))
        seen = []
        ref = jwebcam.process_frame(jargs, frame.copy(), _seen(
            jforward, seen), det_vars, JaxRepresenter(**thresholds), jrec)
        got = webcam.process_frame(args, frame.copy(), forward_of(seen[0]),
                                   SegDetectorRepresenter(**thresholds),
                                   prec)
        np.testing.assert_array_equal(got, ref)
        frames += 1
    cap.release()
    assert frames == FRAMES
    jboxes, jwords = records["jax"]
    boxes, got_words = records["port"]
    assert len(boxes.calls) == len(jboxes.calls) == FRAMES
    for (_, _, (gb, gs)), (_, _, (rb, rs)) in zip(boxes.calls, jboxes.calls):
        np.testing.assert_array_equal(gb, rb)
        np.testing.assert_array_equal(gs, rs)
        assert len(rb) >= 2
    assert len(got_words.calls) == len(jwords.calls)
    for (_, _, got), (_, _, ref) in zip(got_words.calls, jwords.calls):
        assert [r["pred"] for r in got] == [r["pred"] for r in ref]
        np.testing.assert_allclose([r["score"] for r in got],
                                   [r["score"] for r in ref], atol=1e-5)
        words += sum(bool(r["pred"]) for r in ref)
    assert (words > 0) == recognize


def _seen(forward, seen):
    """The JAX forward, keeping each output."""
    def run(variables, x):
        out = np.asarray(forward(variables, x))
        seen.append(out)
        return out

    return run
