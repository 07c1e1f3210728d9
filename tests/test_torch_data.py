"""The PyTorch port's host-side training pieces against the JAX package on
the CPU: device preprocessing of compact batches, GT label maps, the
geometry bindings they use, learning-rate schedules, pixel and box metrics,
the loader, the checkpoint policy and the configuration."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu import config as jax_config
from db_text_minimal_tpu import lr_schedules as JLR
from db_text_minimal_tpu.data import datasets as jax_datasets
from db_text_minimal_tpu.data import labels as jax_labels
from db_text_minimal_tpu.metrics import QuadMetric as JaxQuadMetric
from db_text_minimal_tpu.metrics import RunningScore as JaxRunningScore
from db_text_minimal_tpu.ops import geometry as jax_geo
from db_text_minimal_tpu.train import checkpoints as jax_checkpoints
from db_text_minimal_tpu.train import trainer as jax_trainer
from db_text_minimal_tpu_torch import config, lr_schedules
from db_text_minimal_tpu_torch.data import datasets, labels
from db_text_minimal_tpu_torch.data.scenes import text_batch
from db_text_minimal_tpu_torch.metrics import QuadMetric, RunningScore
from db_text_minimal_tpu_torch.models.prune import load_widths
from db_text_minimal_tpu_torch.ops import geometry as geo
from db_text_minimal_tpu_torch.train import checkpoints
from db_text_minimal_tpu_torch.train import trainer as T

torch.set_num_threads(1)


def test_device_preprocess_matches_jax():
    """A compact batch (uint8 image, np.packbits maps, f16 thresh map) gives
    the same float32 maps exactly; a uint8 map whose width is not W/8 is
    cast, not unpacked."""
    batch = T.array_batch(text_batch(0, 2, 64))
    batch["odd_width"] = None
    ref = jax_trainer.device_preprocess(
        {k: jnp.asarray(v) for k, v in batch.items() if v is not None})
    got = T.device_preprocess(T.to_device(batch, torch.device("cpu")))
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert got["prob_map"].shape == (2, 64, 64)
    assert set(np.unique(got["supervision_mask"].numpy())) <= {0.0, 1.0}
    unpacked = np.unpackbits(batch["prob_map"], axis=-1).astype(np.float32)
    np.testing.assert_array_equal(got["prob_map"].numpy(), unpacked)
    narrow = {"img": torch.zeros((1, 64, 64, 3), dtype=torch.uint8),
              "thresh_map": torch.full((1, 64, 4), 3, dtype=torch.uint8)}
    assert T.device_preprocess(narrow)["thresh_map"].shape == (1, 64, 4)


ANNS = [
    {"poly": np.array([[6, 6], [40, 8], [39, 20], [5, 18]]), "text": "a"},
    {"poly": np.array([[30, 30], [60, 28], [62, 44], [29, 45]]),
     "text": "###"},                                # ignore tag
    {"poly": np.array([[10, 10], [30, 30], [31, 30], [11, 10]]),
     "text": "b"},                                  # the shrink collapses
    {"poly": np.array([[44, 50], [50, 50], [50, 53], [44, 53]]),
     "text": "c"},                                  # below min_text_size
    {"poly": np.array([[8, 40], [20, 34], [26, 46], [22, 58], [10, 56]]),
     "text": "d"},
]


def test_make_gt_maps_matches_jax():
    assert labels.shrink_polygon(ANNS[2]["poly"]) is None
    ref = jax_labels.make_gt_maps(ANNS, 64, ["###"])
    got = labels.make_gt_maps(ANNS, 64, ["###"])
    assert got[4] == ref[4] == [False, True, True, True, False]
    for g, r in zip(got[:4], ref[:4]):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    assert got[0].sum() > 0 and (got[1] == 0).sum() > 0


def test_geometry_bindings_match_jax():
    a, b = ANNS[0]["poly"], ANNS[4]["poly"]
    bowtie = np.array([[0, 0], [10, 10], [10, 0], [0, 10]])
    for poly in (a, b, bowtie, a[:2]):
        assert geo.polygon_is_simple(poly) == jax_geo.polygon_is_simple(poly)
    assert not geo.polygon_is_simple(bowtie)
    shifted = a + [5, 3]
    assert geo.intersection_area(a, shifted) == jax_geo.intersection_area(
        a, shifted) > 0
    assert geo.union_area(a, shifted) == jax_geo.union_area(a, shifted)
    np.testing.assert_array_equal(
        geo.border_distance_field(a, 20, 40, 4.5),
        jax_geo.border_distance_field(a, 20, 40, 4.5))


def test_warmup_poly_lr_matches_jax():
    for kwargs in ({"warmup_iters": 10}, {"warmup_iters": 10,
                                          "max_iters": 50},
                   {"warmup_iters": 5, "warmup_method": "constant",
                    "max_iters": 20}):
        ref = JLR.warmup_poly_lr(0.005, **kwargs)
        got = lr_schedules.warmup_poly_lr(0.005, **kwargs)
        for step in range(0, 60, 3):
            assert float(got(step)) == float(ref(step)), (kwargs, step)


def test_reduce_lr_on_plateau_matches_jax():
    losses = [5.0, 4.0, 4.0, 4.1, 3.9996, 4.2, 4.3, 3.0, 3.5, 3.5, 3.5,
              3.5, 3.5, 3.5]
    ref, got = JLR.ReduceLROnPlateau(patience=2), \
        lr_schedules.ReduceLROnPlateau(patience=2)
    scales = [(got.step(v), ref.step(v)) for v in losses]
    assert all(a == b for a, b in scales)
    assert scales[-1][0] < 1.0


def test_running_score_matches_jax():
    rs = np.random.RandomState(1)
    truth = (rs.rand(3, 16, 16) > 0.6).astype(np.int32)
    pred = (rs.rand(3, 16, 16) > 0.5).astype(np.int32)
    ref, got = JaxRunningScore(2), RunningScore(2)
    ref.update(truth, pred)
    got.update(truth, pred)
    np.testing.assert_array_equal(got.confusion_matrix, ref.confusion_matrix)
    assert got.get_scores() == ref.get_scores()


def test_quad_metric_matches_jax():
    gt = [np.array([[10, 10], [50, 10], [50, 30], [10, 30]]),
          np.array([[60, 60], [90, 60], [90, 80], [60, 80]]),
          np.array([[5, 60], [25, 60], [25, 75], [5, 75]])]
    batch = {"anns": [gt, gt[:1]], "ignore_tags": [[False, False, True],
                                                   [False]]}
    boxes = [[np.array([[12, 11], [50, 11], [50, 31], [12, 31]]),
              np.array([[6, 61], [24, 61], [24, 74], [6, 74]]),
              np.array([[100, 5], [120, 5], [120, 20], [100, 20]])],
             []]
    output = (boxes, [np.ones(len(b), np.float32) for b in boxes])
    ref, got = JaxQuadMetric(), QuadMetric()
    r_ref = ref.validate_measure(batch, output)
    r_got = got.validate_measure(batch, output)
    for g, r in zip(r_got, r_ref):
        # the two geometry builds differ in compiler flags (-march=native
        # and its FMA for the JAX one), so f64 areas may differ in the
        # last bit
        np.testing.assert_allclose(g.pop("iouMat"), r.pop("iouMat"),
                                   rtol=1e-12)
        assert g == r
    g_ref, g_got = ref.gather_measure([r_ref]), got.gather_measure([r_got])
    for key in ("precision", "recall", "fmeasure"):
        assert g_got[key].avg == g_ref[key].avg > 0


class _Samples:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rs = np.random.RandomState(i)
        sample = {"image_path": f"s{i}",
                  "img": rs.randint(0, 255, (16, 16, 3)).astype(np.uint8)}
        for key in T.ARRAY_KEYS[1:]:
            sample[key] = rs.rand(16, 16).astype(np.float32)
        return sample


@pytest.mark.parametrize("shuffle,prefetch", [(True, 2), (False, 0)])
def test_loader_matches_jax(shuffle, prefetch):
    kwargs = {"batch_size": 3, "shuffle": shuffle, "prefetch": prefetch,
              "num_workers": 2}
    ref = jax_datasets.DataLoader(_Samples(8), **kwargs)
    got = datasets.DataLoader(_Samples(8), **kwargs)
    assert len(got) == len(ref)
    for _ in range(2):      # two epochs: the permutation moves on
        pairs = list(zip(got, ref))
        assert len(pairs) == len(ref)
        for g, r in pairs:
            assert g["image_path"] == r["image_path"]
            for key in T.ARRAY_KEYS:
                np.testing.assert_array_equal(g[key], r[key])


def test_checkpoint_policy_writes_the_same_files_as_jax(tmp_path):
    """Both policies save the same checkpoints on the same series, and
    with a pruned model's widths the same ``.widths.json`` sidecars."""
    series = [(3.0, 2.5, 0.1), (2.0, 2.6, 0.05), (1.5, 2.0, 0.3),
              (1.6, 1.9, 0.3), (1.4, 1.8, 0.2)]
    names = ("models/best.ckpt", "models/last.ckpt", "models/hmean.ckpt")
    for widths in (None, {"fpn_out": 64, "head_width": 64}):
        tag = "widths" if widths else "plain"
        written = []
        for root, policy_cls, state in (
                (tmp_path / tag / "jax", jax_checkpoints.CheckpointPolicy,
                 {"step": np.int32(1)}),
                (tmp_path / tag / "port", checkpoints.CheckpointPolicy,
                 {"step": 1})):
            policy = policy_cls(str(root), *names, widths=widths)
            saves = [policy.on_epoch_end(state, train_loss=a, test_loss=b,
                                         hmean=c, epoch=i)
                     for i, (a, b, c) in enumerate(series)]
            policy.on_train_end(state, len(series))
            written.append(([[os.path.relpath(p, root) for p in s]
                             for s in saves],
                            sorted(os.listdir(root / "models"))))
            if widths:
                for name in names:
                    assert load_widths(str(root / name)) == widths
        assert written[0] == written[1]
        sidecars = [".json"] + ([".widths.json"] if widths else [])
        assert written[1][1] == sorted(
            [n.split("/")[1] for n in names]
            + [n.split("/")[1] + ext for n in names for ext in sidecars])


def test_saved_state_restores_bit_equal(tmp_path):
    model = torch.nn.Linear(3, 2)
    optimizer = torch.optim.Adam(model.parameters(), lr=0.01)
    model(torch.ones(4, 3)).sum().backward()
    optimizer.step()
    state = {"model": model.state_dict(),
             "optimizer": optimizer.state_dict(), "step": 7}
    path = str(tmp_path / "cp.ckpt")
    checkpoints.save_checkpoint(path, state, {"note": "test"})
    back = checkpoints.restore_checkpoint(path)
    assert back["step"] == 7 and os.path.exists(path + ".json")
    for key, value in state["model"].items():
        assert torch.equal(back["model"][key], value)
    moments = back["optimizer"]["state"][0]
    assert torch.equal(moments["exp_avg"],
                       optimizer.state_dict()["state"][0]["exp_avg"])
    assert checkpoints.load_params_any(path).keys() == state["model"].keys()
    # a Flax msgpack file is read now (test_torch_flax_ckpt.py); a
    # truncated one is refused, and an orbax directory names the ROADMAP
    with open(tmp_path / "flax.ckpt", "wb") as f:
        f.write(b"\x82\xa6params")
    with pytest.raises(ValueError, match="truncated"):
        checkpoints.load_params_any(str(tmp_path / "flax.ckpt"))
    os.mkdir(tmp_path / "orbax.ckpt")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        checkpoints.load_params_any(str(tmp_path / "orbax.ckpt"))


def test_config_defaults_and_file_match_jax(tmp_path, monkeypatch):
    """The defaults are the JAX package's with ``meta.device`` a torch
    device; ``load_config(None)`` reads ``example_config.yaml`` from the
    working directory, as the JAX one does."""
    got, ref = config.default_config(), jax_config.default_config()
    assert got.meta.device == "cuda" and ref.meta.device == "tpu"
    got.meta.device = ref.meta.device
    assert got == ref
    (tmp_path / "example_config.yaml").write_text(
        "meta:\n  device: cpu\nhps:\n  img_size: 320\n"
        "optimizer:\n  reduction: mean\n")
    monkeypatch.chdir(tmp_path)
    cfg = config.load_config(overrides={"hps": {"batch_size": 2}})
    ref = jax_config.load_config(overrides={"hps": {"batch_size": 2}})
    assert (cfg.meta.device, cfg.hps.img_size, cfg.hps.batch_size,
            cfg.optimizer.reduction, cfg.hps.log_iter) == \
        ("cpu", 320, 2, "mean", 50)
    assert cfg.hps == ref.hps and cfg.optimizer == ref.optimizer
    assert cfg.missing_key is None
    config.save_config(cfg, str(tmp_path / "saved.yaml"))
    assert config.load_config(str(tmp_path / "saved.yaml")) == cfg
