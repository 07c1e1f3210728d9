"""The entry points on the port's other detector families, on the CPU:
``quality_bench.main`` trains deformable_resnet18 + FPN (``--backbone``,
``--dcn_offset_lr_mult``) and resnet18 + FPEM_FFM (``--neck``) on a tiny
generated set and writes the JAX report's keys; ``cli.make_eval`` and
``cli.export`` (flax mode) take its checkpoint with ``--backbone`` alone,
the neck read from the weights: no new flag."""

import json
import pickle

import numpy as np
import pytest
import torch

from db_text_minimal_tpu_torch.cli import export as export_cli
from db_text_minimal_tpu_torch.cli import make_eval
from db_text_minimal_tpu_torch.cli import quality_bench as qb
from db_text_minimal_tpu_torch.cli.common import load_model
from db_text_minimal_tpu_torch.data import synthetic as syn
from db_text_minimal_tpu_torch.serve.export import load_exported
from db_text_minimal_tpu_torch.utils import CAFFE_MEAN

torch.set_num_threads(1)

SIZE = 128


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    syn.generate(str(root / "ds"), n_train=4, n_test=2, size=SIZE, seed=3)
    return root


@pytest.mark.parametrize("flags", [
    ["--backbone", "deformable_resnet18", "--dcn_offset_lr_mult", "0.1"],
    ["--neck", "FPEM_FFM"]], ids=["dcn", "fpem"])
def test_entry_points_run_the_family(flags, dataset, tmp_path,
                                     monkeypatch):
    monkeypatch.chdir(tmp_path)     # the trainer's log file
    ckpt = str(tmp_path / "m.ckpt")
    report = qb.main(qb.load_args([
        "--data_dir", str(dataset / "ds"), "--out",
        str(tmp_path / "report.json"), "--epochs", "1", "--batch_size", "2",
        "--test_batch_size", "2", "--img_size", str(SIZE), "--reduction",
        "none", "--device", "cpu", "--save_checkpoint", ckpt] + flags))
    with open(tmp_path / "report.json") as f:
        assert json.load(f)["config"] == report["config"]
    train = report["config"]["train_config"]
    backbone = "deformable_resnet18" if "--backbone" in flags else "resnet18"
    neck = "FPEM_FFM" if "--neck" in flags else "FPN"
    assert (train["backbone"], train["neck"]) == (backbone, neck)
    assert np.isfinite(report["history"][0]["train_loss"])
    for row in ("host", "device"):
        assert 0.0 <= report["results"][row]["deteval"]["hmean"] <= 1.0

    model = load_model(ckpt, device="cpu", backbone=backbone)
    assert type(model.segmentation_body).__name__ == neck
    argv = ["--image_dir", str(dataset / "ds" / "test_images"),
            "--model_path", ckpt, "--backbone", backbone, "--device", "cpu",
            "--preds_fp", str(tmp_path / "preds.pkl"),
            "--img_fns_fp", str(tmp_path / "fns.pkl")]
    make_eval.main(make_eval.load_args(argv))
    with open(tmp_path / "preds.pkl", "rb") as f:
        assert len(pickle.load(f)) == 2

    path = export_cli.main([
        "--model_path", ckpt, "--backbone", backbone, "--out",
        str(tmp_path / "db.pt2"), "--batch", "2", "--height", "64",
        "--width", "64", "--device", "cpu"])
    x = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3),
                                         dtype=np.uint8)
    live = load_model(ckpt, device="cpu", backbone=backbone,
                      fuse_head=True)
    with torch.no_grad():
        ref = live(torch.from_numpy(x.astype(np.float32)
                                    - np.asarray(CAFFE_MEAN, np.float32)))
    got = load_exported(path, device="cpu")(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
