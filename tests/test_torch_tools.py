"""The port's ``quality_bench --dump_eval_dir`` and the ``Trainer``'s
TensorBoard log against the JAX package's on the CPU, on the same weights
(seeded JAX variables, carried by ``weights.state_dict_from_jax``) and the
same batches:

- ``full_eval``'s dump: the same files (``batch_NNN.npz``,
  ``batch_NNN.boxes.pkl``) and keys; the port's maps JAX's at atol 5e-5
  (the repo's model parity tolerance); on JAX's maps (``full_eval``'s
  ``forward`` returning them) every representer's boxes JAX's exactly, and
  their scores too, but the device rows' (float32 means summed in another
  order) within 1e-6;
- ``fit`` for one epoch (two steps, then the eval) with a recording
  writer passed to both trainers: the same scalar tags at the same steps,
  in the same order, and the same image-grid tags; the train and test
  losses within rtol 1e-5, the rate, accuracy, IoU and test P/R/F within
  1e-6. The rate is 1e-5: Adam moves a weight by about the rate whatever
  its gradient's size, so a gradient within float32 rounding of 0 moves it
  either way, which at the default 0.005 parts the two models' second-step
  losses by ~1e-4."""

import os
import pickle

import numpy as np
import torch

from db_text_minimal_tpu.cli import quality_bench as jqb
from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.parallel import replicate_state
from db_text_minimal_tpu.train import trainer as JT
from db_text_minimal_tpu_torch.cli import quality_bench as qb
from db_text_minimal_tpu_torch.data.scenes import text_batch
from db_text_minimal_tpu_torch.train import trainer as T
from db_text_minimal_tpu_torch.weights import state_dict_from_jax
from torch_tools import ATOL, random_detector_variables

SIZE = 64


def _trainers(tmp_path, args_list):
    """The JAX and the port trainer of ``quality_bench``'s configuration,
    and their states on the same seeded variables."""
    jargs, args = jqb.load_args(args_list), qb.load_args(args_list + [
        "--device", "cpu"])
    jcfg, cfg = jqb.build_cfg(jargs), qb.build_cfg(args)
    for c, name in ((jcfg, "jax"), (cfg, "port")):
        c.meta.root_dir = str(tmp_path / name)
        c.logging.logger_file = None
        c.hps.log_iter = 1
    variables = random_detector_variables(JaxDBTextModel(),
                                          (1, SIZE, SIZE, 3))
    jtrainer = JT.Trainer(jcfg)
    jstate = replicate_state(JT.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtrainer.tx.init(variables["params"]),
        step=np.zeros((), np.int32)), jtrainer.mesh)
    trainer = T.Trainer(cfg)
    state = trainer.init_state()
    state.model.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"]), strict=True)
    return (jargs, jtrainer, jstate), (args, trainer, state)


def _load_dump(folder):
    names = sorted(os.listdir(folder))
    preds = {n: np.load(os.path.join(folder, n)) for n in names
             if n.endswith(".npz")}
    boxes = {}
    for n in names:
        if n.endswith(".pkl"):
            with open(os.path.join(folder, n), "rb") as f:
                boxes[n] = pickle.load(f)
    return names, preds, boxes


def _assert_same_boxes(got, ref):
    assert list(got) == list(ref)
    for row in ref:
        (gb, gs), (rb, rs) = got[row], ref[row]
        assert len(gb) == len(rb)
        for g_img, r_img in zip(gb, rb):
            assert len(g_img) == len(r_img)
            for g, r in zip(g_img, r_img):
                np.testing.assert_array_equal(g, r, err_msg=row)
        for g, r in zip(gs, rs):
            # the device rows' scores are float32 means summed in another
            # order than JAX's: 1e-6
            np.testing.assert_allclose(
                np.asarray(g), np.asarray(r), rtol=0, err_msg=row,
                atol=1e-6 if row.startswith("device") else 0)


def test_dump_eval_dir_matches_jax(tmp_path):
    flags = ["--data_dir", str(tmp_path), "--out", "x.json", "--img_size",
             str(SIZE), "--polygon"]
    (jargs, jtrainer, jstate), (args, trainer, state) = _trainers(
        tmp_path, flags)
    loader = [text_batch(40 + i, 2, SIZE) for i in range(2)]
    jargs.dump_eval_dir = str(tmp_path / "dump_jax")
    jqb.full_eval(jtrainer, jstate, loader, jargs)
    args.dump_eval_dir = str(tmp_path / "dump_port")
    qb.full_eval(trainer, state, loader, args)
    names, jpreds, jboxes = _load_dump(jargs.dump_eval_dir)
    assert names == ["batch_000.boxes.pkl", "batch_000.npz",
                     "batch_001.boxes.pkl", "batch_001.npz"]
    got_names, preds, _ = _load_dump(args.dump_eval_dir)
    assert got_names == names
    for name, ref in jpreds.items():
        assert list(preds[name]) == list(ref) == ["preds"]
        assert preds[name]["preds"].dtype == np.float32
        np.testing.assert_allclose(preds[name]["preds"], ref["preds"],
                                   atol=ATOL, rtol=0)

    # on JAX's maps every row's boxes are JAX's
    maps = iter([torch.from_numpy(jpreds[f"batch_{i:03d}.npz"]["preds"])
                 for i in range(2)])
    args.dump_eval_dir = str(tmp_path / "dump_same")
    qb.full_eval(trainer, state, loader, args,
                 forward=lambda _batch: next(maps))
    _, _, boxes = _load_dump(args.dump_eval_dir)
    assert list(boxes) == list(jboxes)
    n_boxes = 0
    for name, ref in jboxes.items():
        assert list(ref) == ["host", "device", "host_poly", "device_poly"]
        _assert_same_boxes(boxes[name], ref)
        n_boxes += sum(len(b) for b in ref["host"][0])
    assert n_boxes > 0


class _Writer:
    def __init__(self):
        self.scalars, self.images = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def add_image(self, tag, image, step, dataformats):
        self.images.append((tag, int(step), dataformats))


def test_tensorboard_scalars_match_jax(tmp_path):
    flags = ["--data_dir", str(tmp_path), "--out", "x.json", "--img_size",
             str(SIZE), "--reduction", "none", "--lr", "1e-5"]
    (_, jtrainer, jstate), (_, trainer, state) = _trainers(tmp_path, flags)
    train = [text_batch(50 + i, 2, SIZE) for i in range(2)]
    test = [text_batch(60, 2, SIZE)]
    writers = []
    for t, s in ((jtrainer, jstate), (trainer, state)):
        t.train_loader, t.test_loader = train, test
        t.tb_writer = _Writer()
        t.fit(state=s, no_epochs=1)
        writers.append(t.tb_writer)
    ref, got = writers
    assert [(t, s) for t, _, s in got.scalars] == \
        [(t, s) for t, _, s in ref.scalars]
    assert got.images == ref.images
    assert {t for t, _, _ in got.scalars} >= {
        "TRAIN/LOSS/total_loss", "TRAIN/HPs/lr", "TRAIN/ACC_IOU/acc",
        "TRAIN/HPs/images_per_sec", "TEST/hmean"}
    # the train grids after the epoch, then the test grids of the eval's
    # one batch
    assert [i[0] for i in got.images] == [
        f"{mode}/{kind}_imgs" for mode in ("TRAIN", "TEST")
        for kind in ("origin", "prob", "thres")]
    for (tag, g, _), (_, r, _) in zip(got.scalars, ref.scalars):
        if tag.startswith(("TRAIN/LOSS", "TEST/LOSS")):
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=tag)
        elif tag != "TRAIN/HPs/images_per_sec":   # a wall-clock rate
            assert abs(g - r) <= 1e-6, tag


def test_tensorboard_writer_that_fails_to_open_gives_none(tmp_path,
                                                          monkeypatch):
    """As JAX's ``cli/train.py:70-75``: any exception from
    ``SummaryWriter(log_dir)`` leaves training without a writer, not
    stopped; a writer that opens is returned."""
    import torch.utils.tensorboard as tb

    from db_text_minimal_tpu_torch.cli import train as train_cli

    writer = train_cli.tensorboard_writer(str(tmp_path / "ok"))
    assert isinstance(writer, tb.SummaryWriter)
    writer.close()

    class Refuses:
        def __init__(self, log_dir):
            raise PermissionError(f"cannot write {log_dir}")

    monkeypatch.setattr(tb, "SummaryWriter", Refuses)
    assert train_cli.tensorboard_writer(str(tmp_path / "refused")) is None
