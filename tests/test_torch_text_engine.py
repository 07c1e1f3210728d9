"""The port's text-engine seam (``data.text_engine``): a recorded cv2 text
engine replays the hard benchmark without cv2's ``putText``, equal to the
live run under the cv2 that recorded it, and refuses anything that differs
from its trace; the committed trace
(``demo/hard_bench_torch/text_engine_hard_seed7.npz``) replays the first
images of the committed benchmark."""

import glob
import os

import cv2
import numpy as np
import pytest

from db_text_minimal_tpu_torch.cli import make_synthetic
from db_text_minimal_tpu_torch.cli import record_text_engine as rec_cli
from db_text_minimal_tpu_torch.data import synthetic as syn
from db_text_minimal_tpu_torch.data.text_engine import (RecordingTextEngine,
                                                        ReplayTextEngine,
                                                        TraceMismatch,
                                                        gt_digest, load_trace,
                                                        patch_from_mask)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(_REPO, "demo", "hard_bench_torch",
                         "text_engine_hard_seed7.npz")
CV2_5 = cv2.__version__.split(".")[0] == "5"


def _no_put_text(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the replay called cv2.putText")
    monkeypatch.setattr(cv2, "putText", refuse)


def _files(root):
    return {os.path.relpath(p, root): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(root, "*", "*")))}


@pytest.fixture(scope="module")
def small_trace(tmp_path_factory):
    """The first 6 images of ``generate_hard`` at seed 7 (4 train, 2
    test), made live under a recording engine: (trace path, live dir)."""
    root = tmp_path_factory.mktemp("trace")
    engine = RecordingTextEngine()
    syn.generate_hard(str(root / "live"), n_train=4, n_test=2, seed=7,
                      text_engine=engine)
    path = str(root / "trace.npz")
    engine.save(path, {"cv2": cv2.__version__, "generator": "generate_hard",
                       "args": {"n_train": 4, "n_test": 2, "size": 640,
                                "seed": 7}})
    return path, root / "live"


def test_replay_equals_live(small_trace, tmp_path, monkeypatch):
    """Replayed under the cv2 that recorded it, the 6 images and their GT
    files are byte for byte the live run's, every pixel equals the
    recorded one before the encode, and ``putText`` is never called."""
    path, live = small_trace
    _no_put_text(monkeypatch)
    engine = ReplayTextEngine(path)
    syn.generate_hard(str(tmp_path / "replay"), n_train=4, n_test=2, seed=7,
                      text_engine=engine)
    got, want = _files(tmp_path / "replay"), _files(live)
    assert len(want) == 12 and got == want
    assert engine.images == engine.pixels_equal == 6
    assert engine.n_size == len(engine.trace["size_result"]) > 0
    assert engine.n_draw == len(engine.trace["draw_shape"]) > 0


def test_default_engine_is_cv2_and_unchanged(small_trace, tmp_path):
    """Without an engine, ``generate_hard`` still calls cv2 and writes
    what the recording run wrote."""
    _, live = small_trace
    syn.generate_hard(str(tmp_path / "plain"), n_train=4, n_test=2, seed=7)
    assert _files(tmp_path / "plain") == _files(live)


@pytest.fixture(scope="module")
def committed():
    return load_trace(COMMITTED)


def test_committed_trace_prefix_replays(committed, tmp_path, monkeypatch):
    """The committed trace: recorded under cv2 5.0.0 over the hard
    benchmark's 1600 + 400 images at seed 7, under 20 MB; its first 3
    images replay without ``putText``, each GT file equal to the header's
    hash (the engine checks them as it goes; checked here again)."""
    header = committed["header"]
    assert header["cv2"] == "5.0.0" and header["n_images"] == 2000
    assert header["args"] == rec_cli.HARD_ARGS
    assert os.path.getsize(COMMITTED) < 20 * 2 ** 20
    _no_put_text(monkeypatch)
    engine = ReplayTextEngine(committed)
    syn.generate_hard(str(tmp_path), n_train=3, n_test=0, seed=7,
                      text_engine=engine)
    assert engine.images == 3
    for i in range(3):
        with open(tmp_path / "train_gts" / f"gt_img{i}.txt") as f:
            lines = f.read().splitlines()
        assert gt_digest(lines).encode() == committed["gt_sha256"][i]
    if CV2_5:
        assert engine.pixels_equal == 3


def test_replay_refuses_a_wrong_argument(small_trace):
    engine = ReplayTextEngine(small_trace[0])
    with pytest.raises(TraceMismatch, match=r"size call 0: arguments "
                       r"\('AB', 0, 1.0, 1\), the trace has"):
        engine.text_size("AB", 0, 1.0, 1)
    # another seed asks for other glyphs at the first call
    with pytest.raises(TraceMismatch, match="call 0: arguments"):
        syn.generate_hard("unused", n_train=1, n_test=0, seed=8,
                          text_engine=ReplayTextEngine(small_trace[0]))


def test_replay_refuses_past_the_end(small_trace, tmp_path):
    engine = ReplayTextEngine(small_trace[0])
    with pytest.raises(TraceMismatch, match=r"call \d+: past the end of "
                       r"the trace|image 6: past the end"):
        syn.generate_hard(str(tmp_path), n_train=7, n_test=0, seed=7,
                          text_engine=engine)
    assert engine.images == 6


def test_replay_refuses_another_gt(small_trace, tmp_path):
    trace = load_trace(small_trace[0])
    trace["gt_sha256"] = trace["gt_sha256"].copy()
    trace["gt_sha256"][1] = b"0" * 64
    engine = ReplayTextEngine(trace)
    with pytest.raises(TraceMismatch, match="image 1: its GT differs"):
        syn.generate_hard(str(tmp_path), n_train=2, n_test=0, seed=7,
                          text_engine=engine)


def test_make_synthetic_replays_and_refuses_other_arguments(
        small_trace, tmp_path, capsys, monkeypatch):
    """``make_synthetic --hard --text_trace`` takes the trace's counts,
    size and seed, reports the images written and those with the recorded
    pixels, and refuses other arguments, or a generator other than
    ``--hard``, with a message naming them."""
    path, live = small_trace
    _no_put_text(monkeypatch)
    out = tmp_path / "cli"
    make_synthetic.main([str(out), "--hard", "--text_trace", path])
    captured = capsys.readouterr()
    assert "synthetic" in captured.out
    assert "wrote 6 images" in captured.err
    expected = "6 of them" if CV2_5 else "of them"
    assert expected in captured.err
    assert _files(out).keys() == _files(live).keys()
    for argv, message in (
            (["--seed", "8"], "--seed 8: the trace"),
            (["--n_train", "5"], "--n_train 5: the trace"),
            (["--size", "320"], "--size 320: the trace"),
            (["--ctw"], "replays the --hard benchmark only")):
        with pytest.raises(SystemExit):
            make_synthetic.main([str(tmp_path / "x"), "--hard",
                                 "--text_trace", path] + argv)
        assert message in capsys.readouterr().err
    with pytest.raises(SystemExit):
        make_synthetic.main([str(tmp_path / "x"), "--text_trace", path])
    assert "--hard benchmark only" in capsys.readouterr().err


def test_recorder_refuses_another_cv2(monkeypatch, tmp_path):
    monkeypatch.setattr(cv2, "__version__", "4.13.0")
    with pytest.raises(SystemExit, match="cv2 4.13.0: the committed GT was "
                       "made under cv2 5.0.0"):
        rec_cli.record(str(tmp_path / "t.npz"), str(tmp_path))
    assert not os.path.exists(tmp_path / "t.npz")


@pytest.mark.skipif(not CV2_5, reason="the rule is cv2 5.x's antialiased "
                    "putText; the committed trace was recorded under 5.0.0")
def test_patch_rule_against_cv2():
    """On random glyphs (all three fonts, scales 0.45-2.0, random colours)
    the colour patch that ``putText`` draws on zeros is
    ``(color * mask + 127) // 255`` of its 255 mask to within 1 at every
    pixel, and exactly in most calls; a recording keeps the off pixels and
    its replay rebuilds cv2's patch exactly."""
    rs = np.random.RandomState(3)
    recorder = RecordingTextEngine()
    calls, exact = [], 0
    for _ in range(300):
        text = "".join(rs.choice(list(syn._UPPER), rs.randint(1, 9)))
        font = int(rs.choice([cv2.FONT_HERSHEY_SIMPLEX,
                              cv2.FONT_HERSHEY_DUPLEX,
                              cv2.FONT_HERSHEY_COMPLEX_SMALL]))
        scale = float(rs.uniform(0.45, 2.0))
        color = tuple(int(v) for v in rs.randint(0, 256, 3))
        thickness = 1 + int(scale)
        (w, h), base = recorder.text_size(text, font, scale, thickness)
        args = ((h + base + 6, w + 6), text, (3, 3 + h), font, scale,
                color, thickness)
        patch, mask = recorder.draw(*args)
        rule = patch_from_mask(color, mask)
        assert np.abs(rule - patch).max() <= 1
        exact += np.array_equal(rule, patch)
        calls.append((args, patch, mask))
    assert exact >= 270
    recorder.end_image(np.zeros((1, 1, 3), np.uint8), [])
    replay = ReplayTextEngine({**recorder.arrays({}),
                               "header": {"format": 1}})
    for args, patch, mask in calls:
        replay.text_size(args[1], args[3], args[4], args[6])
        got_patch, got_mask = replay.draw(*args)
        np.testing.assert_array_equal(got_patch, patch)
        np.testing.assert_array_equal(got_mask, mask)
