"""The port's cv2 data pipeline against the JAX package on the CPU: the
augmentation, ``BaseDataset`` samples, ``DATASETS``, the synthetic
generators and ``make_synthetic``, ``quality_bench.main`` and
``cli.train``. The same cv2, numpy and geometry library run on both sides,
so everything matches exactly.

The JAX package's data modules import without jax; the tests that need
jax import it inside, so that on a machine without jax
``python -m pytest --noconftest -m slow tests/test_torch_datasets.py``
runs the hard-bench GT check alone."""

import glob
import json
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from db_text_minimal_tpu.data import augment as jaug
from db_text_minimal_tpu.data import datasets as jds
from db_text_minimal_tpu.data import synthetic as jsyn
from db_text_minimal_tpu_torch.cli import make_synthetic
from db_text_minimal_tpu_torch.cli import quality_bench as qb
from db_text_minimal_tpu_torch.cli import train as train_cli
from db_text_minimal_tpu_torch.data import augment as aug
from db_text_minimal_tpu_torch.data import datasets as ds
from db_text_minimal_tpu_torch.data import synthetic as syn

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 2, 3)
SHAPES = ((480, 640), (640, 480), (203, 333))


def _scene(seed, shape):
    """A noise image with a dark band of text-free rows and columns, and
    its annotations: quads at small angles and a 14-point curved word."""
    rng = np.random.RandomState(100 + seed)
    h, w = shape
    img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
    anns = []
    for i in range(3):
        x, y = rng.uniform(0.1, 0.6) * w, rng.uniform(0.1, 0.7) * h
        bw, bh = rng.uniform(0.1, 0.3) * w, rng.uniform(0.04, 0.1) * h
        anns.append({"poly": [[x, y], [x + bw, y + 2], [x + bw, y + bh],
                              [x - 1, y + bh - 2]],
                     "text": "###" if i == 2 else f"w{i}"})
    ts = np.linspace(0, 1, 7)
    top = np.stack([0.2 * w + ts * 0.5 * w,
                    0.8 * h - 0.05 * h * np.sin(ts * np.pi)], axis=1)
    anns.append({"poly": np.concatenate(
        [top, (top + [0, 0.06 * h])[::-1]]).tolist(), "text": "curve"})
    return img, anns


def _same(got, ref):
    """Image bytes and polygons equal, and the generators left in the same
    state (the same draws, in the same order)."""
    (img, anns, rng), (rimg, ranns, rrng) = got, ref
    assert img.dtype == rimg.dtype and img.shape == rimg.shape
    np.testing.assert_array_equal(img, rimg)
    assert anns == ranns
    assert all(np.array_equal(a, b) for a, b in zip(rng.get_state(),
                                                    rrng.get_state()))


def _run(fn, seed, *args):
    rng = np.random.RandomState(seed)
    img, anns = fn(rng, *args)
    return np.asarray(img), anns, rng


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_flip_rotate_resize_matches_jax(seed, shape):
    img, anns = _scene(seed, shape)
    _same(_run(aug.random_flip_rotate_resize, seed, img, anns),
          _run(jaug.random_flip_rotate_resize, seed, img, anns))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_crop_matches_jax(seed, shape):
    """After the flip/rotate/resize, as in a training sample; the crop must
    have cut the image in some of these cases."""
    img, anns = _scene(seed, shape)
    img, anns = jaug.random_flip_rotate_resize(np.random.RandomState(seed),
                                               img, anns)
    got = _run(aug.crop, seed, img, anns)
    _same(got, _run(jaug.crop, seed, img, anns))
    if seed == 0:
        assert got[0].shape != img.shape


@pytest.mark.parametrize("size", (640, 128, 100))
@pytest.mark.parametrize("shape", SHAPES)
def test_resize_square_pad_matches_jax(shape, size):
    img, anns = _scene(0, shape)
    got = aug.resize_square_pad(size, img, anns)
    ref = jaug.resize_square_pad(size, img, anns)
    assert got[0].shape == (size, size, 3)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1]


# ------------------------------------------------------------- datasets --

@pytest.fixture(scope="module")
def synthetic_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    syn.generate(root, n_train=4, n_test=2, size=256, seed=5,
                 curved_prob=0.5)
    return root


MAPS = ("img", "prob_map", "supervision_mask", "thresh_map",
        "text_area_map")


@pytest.mark.parametrize("image_size", (128, 100))
@pytest.mark.parametrize("compact", (False, True))
@pytest.mark.parametrize("is_training", (True, False))
def test_dataset_samples_match_jax(synthetic_dir, is_training, compact,
                                   image_size):
    """All five maps (and in eval mode the polygons and ignore flags) at
    several (seed, epoch, index); 100 is not a multiple of 8, so the
    compact maps there are plain uint8, not bit-packed."""
    img_dir = os.path.join(synthetic_dir, "train_images")
    gt_dir = os.path.join(synthetic_dir, "train_gts")
    for seed, epoch, index in ((42, 0, 0), (42, 3, 2), (7, 1, 3)):
        pair = [cls(img_dir, gt_dir, ["###"], is_training=is_training,
                    image_size=image_size, seed=seed, compact_dtypes=compact)
                for cls in (ds.TotalTextDataset, jds.TotalTextDataset)]
        for d in pair:
            d.epoch = epoch
        got, ref = (d[index] for d in pair)
        assert sorted(got) == sorted(ref)
        for key in MAPS:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        if compact and image_size % 8 == 0:
            assert got["prob_map"].shape == (image_size, image_size // 8)
        if not is_training:
            assert got["anns"] == ref["anns"]
            assert got["ignore_tags"] == ref["ignore_tags"]
        assert got["prob_map"].any() and got["image_path"] == \
            ref["image_path"]


def test_datasets_name_the_jax_parsers(synthetic_dir):
    """``DATASETS`` has the JAX keys, classes and parsers, and
    ``build_dataset`` makes the same dataset from a configuration."""
    from db_text_minimal_tpu_torch.config import load_config

    assert list(ds.DATASETS) == list(jds.DATASETS)
    for key, cls in ds.DATASETS.items():
        ref = jds.DATASETS[key]
        assert cls.__name__ == ref.__name__
        assert cls.parser.__name__ == ref.parser.__name__
    section = {"train_dir": os.path.join(synthetic_dir, "train_images"),
               "train_gt_dir": os.path.join(synthetic_dir, "train_gts"),
               "test_dir": os.path.join(synthetic_dir, "test_images"),
               "test_gt_dir": os.path.join(synthetic_dir, "test_gts"),
               "ignore_tags": ["###"]}
    cfg = load_config("/nonexistent", {"data": {"synthetic": section},
                                       "dataset": {"name": "synthetic"},
                                       "hps": {"img_size": 128}})
    for is_training, n in ((True, 4), (False, 2)):
        got = ds.build_dataset(cfg, is_training)
        ref = jds.build_dataset(cfg, is_training)
        assert type(got).__name__ == type(ref).__name__
        assert len(got) == len(ref) == n
        assert got.compact_dtypes and got.seed == ref.seed == 42
        for key in MAPS:
            np.testing.assert_array_equal(got[1][key], ref[1][key])


def test_loader_times_each_sample(synthetic_dir):
    dataset = ds.TotalTextDataset(
        os.path.join(synthetic_dir, "train_images"),
        os.path.join(synthetic_dir, "train_gts"), ["###"], image_size=64,
        compact_dtypes=True)
    loader = ds.DataLoader(dataset, 2, shuffle=True)
    batches = list(loader)
    assert len(batches) == 2 and batches[0]["img"].shape == (2, 64, 64, 3)
    assert len(loader.sample_seconds) == 4
    assert all(s > 0 for s in loader.sample_seconds)
    assert dataset.epoch == 0 and loader.epoch == 1


# ----------------------------------------------------------- generators --

def _capture(monkeypatch, fn, out_dir, **kwargs):
    """Run a generator with ``cv2.imwrite`` recording the pixels it is
    given; returns (section, [(file name, pixels)], {GT file: text})."""
    written = []
    monkeypatch.setattr(cv2, "imwrite", lambda path, img: written.append(
        (os.path.basename(path), img.copy())) or True)
    section = fn(out_dir, **kwargs)
    gts = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*_gts", "*.txt"))):
        with open(path) as f:
            gts[os.path.relpath(path, out_dir)] = f.read()
    section = {k: os.path.relpath(v, out_dir) if k.endswith("dir") else v
               for k, v in section.items()}
    return section, written, gts


GENERATORS = {
    "generate": dict(n_train=2, n_test=2, size=256, seed=3,
                     curved_prob=0.5),
    "generate_hard": dict(n_train=2, n_test=2, size=640, seed=7),
    "generate_hard_ctw": dict(n_train=2, n_test=2, size=640, seed=11),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match_jax(name, tmp_path, monkeypatch):
    """Equal GT files and equal pixels before ``imwrite``."""
    kwargs = GENERATORS[name]
    got = _capture(monkeypatch, getattr(syn, name), str(tmp_path / "port"),
                   **kwargs)
    ref = _capture(monkeypatch, getattr(jsyn, name), str(tmp_path / "jax"),
                   **kwargs)
    assert got[0] == ref[0]
    assert [n for n, _ in got[1]] == [n for n, _ in ref[1]]
    assert len(got[1]) == 4
    for (n, img), (_, rimg) in zip(got[1], ref[1]):
        np.testing.assert_array_equal(img, rimg, err_msg=n)
    assert got[2] == ref[2] and len(got[2]) == 4
    assert all(text.strip() for text in got[2].values())


@pytest.mark.parametrize("flags", ([], ["--hard"], ["--ctw"]))
def test_make_synthetic_prints_the_jax_yaml(flags, tmp_path, capsys):
    from db_text_minimal_tpu.cli import make_synthetic as jmake_synthetic

    argv = [str(tmp_path / "ds"), "--n_train", "1", "--n_test", "1",
            "--size", "256"] + flags
    jmake_synthetic.main(argv)
    ref = capsys.readouterr().out
    ref_gts = sorted(glob.glob(str(tmp_path / "ds" / "*_gts" / "*.txt")))
    ref_text = [open(p).read() for p in ref_gts]
    make_synthetic.main(argv)
    assert capsys.readouterr().out == ref
    assert [open(p).read() for p in ref_gts] == ref_text
    assert "dataset:" in ref and "train_dir" in ref


@pytest.mark.slow
def test_hard_bench_gt_matches_the_committed_pickle(tmp_path, capsys):
    """``make_synthetic --hard`` (1600/400 at seed 7): its test GT, parsed
    and exported by the port's ``make_eval.export_gts`` in the order of
    ``img_fns.pkl``, equals ``demo/hard_bench/result_poly_gts.pkl`` for
    all 400 images (~80 s). That GT was made with cv2 5.0.0, whose text
    engine sizes the glyphs; another cv2 draws other words, so under a cv2
    other than 5.x the test replays the committed trace of cv2 5.0.0's
    text engine (``--text_trace``), and under 5.x it generates live."""
    from argparse import Namespace

    from db_text_minimal_tpu_torch.cli.make_eval import export_gts

    data_dir = tmp_path / "hb"
    replay = cv2.__version__.split(".")[0] != "5"
    trace = os.path.join(_REPO, "demo", "hard_bench_torch",
                         "text_engine_hard_seed7.npz")
    route = "the committed trace replayed" if replay else "live"
    make_synthetic.main([str(data_dir), "--hard"]
                        + (["--text_trace", trace] if replay else []))
    assert "synthetic" in capsys.readouterr().out
    bench = os.path.join(_REPO, "demo", "hard_bench")
    with open(os.path.join(bench, "img_fns.pkl"), "rb") as f:
        img_fns = pickle.load(f)
    with open(os.path.join(bench, "result_poly_gts.pkl"), "rb") as f:
        ref = pickle.load(f)
    args = Namespace(dataset="totaltext", ignore_tags=["###"],
                     image_dir=str(data_dir / "test_images"),
                     gt_dir=str(data_dir / "test_gts"),
                     gts_fp=str(tmp_path / "gts.pkl"))
    export_gts(args, [str(data_dir / "test_images" / n) for n in img_fns])
    with open(args.gts_fp, "rb") as f:
        got = pickle.load(f)
    assert len(img_fns) == len(ref) == len(got) == 400
    equal = sum(g == r for g, r in zip(got, ref))
    # the glyphs' sizes come from cv2's text engine, which differs
    # between cv2 versions; the committed GT was made with cv2 5.0.0
    size = cv2.getTextSize("HELLO", cv2.FONT_HERSHEY_SIMPLEX, 0.45, 1)
    assert equal == 400, (f"{equal} of 400 images equal under cv2 "
                          f"{cv2.__version__}, {route} (HELLO at scale "
                          f"0.45: {size})")
    assert len(os.listdir(data_dir / "train_images")) == 1600


# -------------------------------------------------------- quality bench --

def _bench_argv(data_dir, out, *extra):
    return (["--data_dir", str(data_dir), "--out", str(out),
             "--test_batch_size", "2", "--img_size", "192"] + list(extra))


def _detections_as_gt(root, weights, per_image=5):
    """Rewrite the test split's GT as the ``per_image`` highest-scoring
    rect-mode boxes that the port's host representer finds with
    ``weights``, so that the parity check below compares non-zero P/R/F
    (a model trained for seconds on the CPU finds no GT word reliably)."""
    from db_text_minimal_tpu_torch.cli.common import load_model, make_forward
    from db_text_minimal_tpu_torch.postprocess import SegDetectorRepresenter
    from db_text_minimal_tpu_torch.utils import filter_zero_boxes

    test = ds.TotalTextDataset(str(root / "ds" / "test_images"),
                               str(root / "ds" / "test_gts"), ["###"],
                               is_training=False, image_size=192)
    images = np.stack([test[i]["img"] for i in range(len(test))])
    preds = make_forward(load_model(weights, device="cpu"))(images).numpy()
    boxes, scores = SegDetectorRepresenter(thresh=0.25, box_thresh=0.5)(
        {"shape": [(192, 192)] * len(test)}, preds, is_output_polygon=False)
    found = 0
    for path, b, sc in zip(test.image_paths, boxes, scores):
        b, sc = filter_zero_boxes(b, sc, is_output_polygon=False)
        top = np.asarray(b)[np.argsort(-np.asarray(sc))[:per_image]]
        found += len(top)
        name = "gt_" + os.path.splitext(os.path.basename(path))[0] + ".txt"
        with open(root / "ds" / "test_gts" / name, "w") as f:
            f.write("".join(",".join(str(int(v)) for v in box.reshape(-1))
                            + ",word\n" for box in top))
    assert found > 0


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A tiny ``generate`` set at 192 (as tests/test_quality_bench.py
    uses); the port trains on it for 2 epochs and saves its checkpoint;
    its weights go to a JAX checkpoint through the JAX package's converter
    and back to a ``.pth`` through the port's ``weights.state_dict_from_jax``,
    so both packages hold the same tree. The test split's GT is then
    rewritten from that tree's detections (``_detections_as_gt``)."""
    from db_text_minimal_tpu.train import checkpoints as jckpt
    from db_text_minimal_tpu_torch.train.checkpoints import \
        restore_checkpoint
    from db_text_minimal_tpu_torch.weights import state_dict_from_jax

    root = tmp_path_factory.mktemp("bench")
    syn.generate(str(root / "ds"), n_train=8, n_test=2, size=192, seed=11)
    cwd = os.getcwd()
    os.chdir(root)       # the trainer's log file goes to the cwd
    try:
        torch.manual_seed(0)
        train_report = qb.main(qb.load_args(_bench_argv(
            root / "ds", root / "train.json", "--epochs", "2",
            "--batch_size", "4", "--lr", "0.002", "--device", "cpu",
            "--save_checkpoint", str(root / "m.ckpt"))))
    finally:
        os.chdir(cwd)
    torch.save(restore_checkpoint(str(root / "m.ckpt"))["model"],
               str(root / "trained.pth"))
    tree = jckpt.load_params_any(str(root / "trained.pth"))
    jckpt.save_checkpoint(str(root / "jax.ckpt"), tree)
    torch.save(state_dict_from_jax(tree["params"], tree["batch_stats"]),
               str(root / "carried.pth"))
    _detections_as_gt(root, str(root / "carried.pth"))
    return root, train_report


@pytest.fixture(scope="module")
def eval_reports(bench, tmp_path_factory):
    """``--eval_only`` reports on the same weights: the JAX package's from
    its checkpoint, the port's from its own checkpoint and from the
    ``.pth`` that ``weights.py`` made of the JAX tree."""
    from db_text_minimal_tpu.cli import quality_bench as jqb

    root, _ = bench
    out = tmp_path_factory.mktemp("eval")
    cwd = os.getcwd()
    os.chdir(out)
    try:
        ref = jqb.main(jqb.load_args(_bench_argv(
            root / "ds", out / "jax.json", "--eval_only", "--checkpoint",
            str(root / "jax.ckpt"))))
        got = {name: qb.main(qb.load_args(_bench_argv(
            root / "ds", out / f"{name}.json", "--eval_only",
            "--checkpoint", str(root / name), "--device", "cpu")))
            for name in ("m.ckpt", "carried.pth")}
    finally:
        os.chdir(cwd)
    return ref, got, out


def test_quality_bench_report_has_the_jax_keys(bench, eval_reports):
    """The same keys at every level of the ``--eval_only`` reports (the
    config's plus ``compute_dtype``, float32 on the CPU); the training
    report the same top-level and config keys, its history
    entries the JAX entry's keys and the three timing keys; the
    checkpoint's sidecar read back."""
    _, train_report = bench
    ref, got, out = eval_reports
    got = got["m.ckpt"]
    # the port's config also records the compute dtype, beside the backend
    config_keys = list(ref["config"])
    config_keys.insert(config_keys.index("backend") + 1, "compute_dtype")
    for report in (got, train_report):
        assert list(report) == list(ref)
        assert list(report["config"]) == config_keys
        assert report["config"]["compute_dtype"] == "float32"
    assert list(got["results"]) == list(ref["results"])
    for row in ("host", "device"):
        assert list(got["results"][row]) == list(ref["results"][row])
        for proto in ("iou_pascal", "deteval"):
            assert list(got["results"][row][proto]) == \
                list(ref["results"][row][proto])
    assert got["config"]["backend"] == "cpu"
    assert got["config"]["train_config"]["epochs"] == 2
    assert json.load(open(out / "m.ckpt.json")) == got
    history = train_report["history"]
    assert [h["epoch"] for h in history] == list(range(2))
    for entry in history:
        assert set(entry) == {"epoch", "train_loss", "wall_s",
                              "loader_wait_s", "sample_ms"}
        assert 0 <= entry["loader_wait_s"] <= entry["wall_s"]
        assert entry["sample_ms"] > 0
    assert history[-1]["train_loss"] < history[0]["train_loss"]


def test_quality_bench_eval_only_rect_rows_match_jax(eval_reports):
    """The same weights (the port's ``.pth`` made by ``weights.py`` from
    the JAX tree) give the same rect-row P/R/F, host and device, under
    both protocols, non-zero on the GT made from the detections; the
    port's own checkpoint scores as the carried weights do."""
    ref, got, _ = eval_reports
    for row in ("host", "device"):
        for proto in ("iou_pascal", "deteval"):
            want = ref["results"][row][proto]
            assert got["carried.pth"]["results"][row][proto] == want
            assert got["m.ckpt"]["results"][row][proto] == want
    assert got["carried.pth"]["results"]["n_test_images"] == 2
    for row in ("host", "device"):
        assert ref["results"][row]["iou_pascal"]["recall"] > 0.5


def test_checkpoint_saved_before_final_eval(tmp_path, monkeypatch):
    """A failing final eval does not lose the training: the checkpoint and
    its ``.train_config.json`` sidecar are written first."""
    syn.generate(str(tmp_path / "ds"), n_train=2, n_test=2, size=192,
                 seed=11)
    monkeypatch.chdir(tmp_path)

    def boom(*args, **kwargs):
        raise RuntimeError("the eval failed")

    monkeypatch.setattr(qb, "full_eval", boom)
    ckpt = str(tmp_path / "m.ckpt")
    with pytest.raises(RuntimeError, match="the eval failed"):
        qb.main(qb.load_args(_bench_argv(
            tmp_path / "ds", tmp_path / "m.json", "--epochs", "1",
            "--batch_size", "2", "--device", "cpu", "--save_checkpoint",
            ckpt)))
    assert os.path.exists(ckpt)
    with open(ckpt + ".train_config.json") as f:
        assert json.load(f)["epochs"] == 1
    report = qb.main(qb.load_args(_bench_argv(
        tmp_path / "ds", tmp_path / "m.json", "--epochs", "0",
        "--checkpoint", ckpt, "--no_final_eval", "--device", "cpu")))
    assert report["results"] == {"skipped": True}


def test_pruned_widths_raise_through_the_trainer(tmp_path):
    """A pruned checkpoint's sidecar reaches the configuration and, since
    pruning is ported, the Trainer: ``--eval_only`` builds the narrow
    model (the head at width 32) and evaluates it."""
    from db_text_minimal_tpu_torch.models import DBTextModel

    syn.generate(str(tmp_path / "ds"), n_train=1, n_test=1, size=64,
                 seed=1)
    ckpt = str(tmp_path / "p.pth")
    model = DBTextModel(head_width=32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), ckpt)
    with open(ckpt + ".widths.json", "w") as f:
        json.dump({"head_width": 32}, f)
    args = qb.load_args(_bench_argv(tmp_path / "ds", tmp_path / "m.json",
                                    "--eval_only", "--checkpoint", ckpt,
                                    "--device", "cpu"))
    assert qb.build_cfg(args).model.widths == {"head_width": 32}
    report = qb.main(args)
    assert report["config"]["checkpoint"] == ckpt
    assert set(report["results"]) == {"host", "device", "n_test_images"}


# ------------------------------------------------------------ cli.train --

def test_train_cli_resumes_the_state_bit_for_bit(tmp_path, monkeypatch):
    """One epoch of ``cli.train --device cpu`` on a tiny ``generate`` set,
    then ``--resume`` of its last checkpoint with no epochs: the weights,
    BN statistics, Adam moments and step come back bit for bit."""
    import yaml

    section = syn.generate(str(tmp_path / "ds"), n_train=4, n_test=2,
                           size=64, seed=2)
    config = tmp_path / "config.yaml"
    with open(config, "w") as f:
        yaml.safe_dump({"meta": {"root_dir": str(tmp_path)},
                        "dataset": {"name": "synthetic"},
                        "data": {"synthetic": section},
                        "hps": {"img_size": 64, "batch_size": 2,
                                "test_batch_size": 2}}, f)
    monkeypatch.chdir(tmp_path)
    state, history = train_cli.main(train_cli.load_args(
        ["--config", str(config), "--epochs", "1", "--device", "cpu"]))
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    assert state.step == 2
    last = str(tmp_path / "models" / "last_cp.ckpt")
    resumed, history = train_cli.main(train_cli.load_args(
        ["--config", str(config), "--epochs", "0", "--device", "cpu",
         "--resume", last]))
    assert history == [] and resumed.step == state.step
    want, got = state.state_dict(), resumed.state_dict()
    assert list(got["model"]) == list(want["model"])
    for key, value in want["model"].items():
        assert torch.equal(got["model"][key], value), key
    opt_want, opt_got = want["optimizer"], got["optimizer"]
    assert opt_got["param_groups"] == opt_want["param_groups"]
    assert list(opt_got["state"]) == list(opt_want["state"])
    for index, slots in opt_want["state"].items():
        for name, value in slots.items():
            assert torch.equal(opt_got["state"][index][name], value)


def test_quality_bench_seed_sets_the_trainer_seed(tmp_path):
    """``--seed`` reaches ``trainer.seed`` (42 without it, as before)."""
    argv = ["--data_dir", str(tmp_path), "--out", str(tmp_path / "m.json"),
            "--device", "cpu"]
    assert qb.build_cfg(qb.load_args(argv)).trainer.seed == 42
    assert qb.build_cfg(qb.load_args(argv + ["--seed", "7"])).trainer.seed \
        == 7
