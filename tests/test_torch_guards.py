"""Guards on the PyTorch port: it imports neither JAX nor the JAX package,
and its entry points never fall back to the CPU on their own."""

import os
import re
import subprocess
import sys

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO, "db_text_minimal_tpu_torch")


def _port_sources():
    for root, _, files in os.walk(_PORT):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(_REPO, "chip_smoke.py")
    yield os.path.join(_REPO, "compare_kernels.py")
    yield os.path.join(_REPO, "compare_int8.py")


def test_port_imports_with_jax_blocked():
    """Every module of the port, chip_smoke.py, compare_kernels.py and
    compare_int8.py import in a process where jax, flax, optax and the JAX package cannot
    be imported (this process already holds jax, so the check runs in a
    subprocess)."""
    snippet = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "db_text_minimal_tpu"):
    sys.modules[name] = None
import db_text_minimal_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke", "compare_kernels", "compare_int8"]:
    importlib.import_module(name)
print(" ".join(names))
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", snippet], cwd=_REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    *names, count = proc.stdout.split()
    for module in ("data.augment", "data.datasets", "data.synthetic",
                   "data.text_engine", "cli.train", "cli.make_synthetic",
                   "cli.quality_bench", "cli.record_text_engine",
                   "models.prune", "cli.prune", "cli.export",
                   "serve.export", "serve.client", "models.recognition",
                   "train.recognition_trainer", "cli.ocr", "cli.rec_bench",
                   "cli.train_rec", "models.deform", "utils",
                   "utils.visualize", "utils.profiling", "cli.test",
                   "cli.webcam", "cli.pretrain_backbone",
                   "train.backbone_pretrain", "train.flax_msgpack",
                   "parallel", "ops.deform", "ops.int8"):
        assert f"db_text_minimal_tpu_torch.{module}" in names
    assert int(count) >= 67


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|"
        r"db_text_minimal_tpu(?!_torch))\b", re.M)
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            offenders += [f"{path}: {m.group(0).strip()}"
                          for m in pattern.finditer(f.read())]
    assert not offenders


def test_entry_points_refuse_to_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from db_text_minimal_tpu_torch.cli.common import load_model
    from db_text_minimal_tpu_torch.serve.handler import \
        DBTextDetectionHandler

    path = str(tmp_path / "model.pth")
    torch.save({}, path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DBTextDetectionHandler(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(path)
    from db_text_minimal_tpu_torch.config import default_config
    from db_text_minimal_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(default_config())
    from db_text_minimal_tpu_torch.cli import quality_bench
    from db_text_minimal_tpu_torch.cli.common import build_inference_forward

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_inference_forward(path)
    args = quality_bench.load_args(["--data_dir", str(tmp_path), "--out",
                                    str(tmp_path / "x.json")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(quality_bench.build_cfg(args))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quality_bench.main(args)
    from db_text_minimal_tpu_torch.cli import train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(train.load_args(["--config", str(tmp_path / "none.yaml"),
                                    "--epochs", "1"]))
    from db_text_minimal_tpu_torch.cli import export, prune
    from db_text_minimal_tpu_torch.serve.export import (export_model,
                                                        load_exported)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        prune.main(prune.load_args(["--checkpoint", path, "--out",
                                    str(tmp_path / "p.pth")]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.main(["--model_path", path, "--out", str(tmp_path / "m.pt2")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_model({}, str(tmp_path / "m.pt2"), infer_mode="folded")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_exported(str(tmp_path / "m.pt2"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DBTextDetectionHandler(str(tmp_path / "m.pt2"))
    from db_text_minimal_tpu_torch.cli import ocr, rec_bench, train_rec

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ocr.main(ocr.load_args(["--img_path", str(tmp_path / "x.jpg"),
                                "--det_model_path", path]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rec_bench.main(rec_bench.load_args(
            ["--mode", "rec", "--data_dir", str(tmp_path), "--out",
             str(tmp_path / "r.json"), "--saved_model", path]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_rec.main(train_rec.load_args(["--crop_dir", str(tmp_path)]))
    from db_text_minimal_tpu_torch.cli import pretrain_backbone
    from db_text_minimal_tpu_torch.cli import test as test_cli
    from db_text_minimal_tpu_torch.cli import webcam
    from db_text_minimal_tpu_torch.train import backbone_pretrain

    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_cli.main(test_cli.load_args(["--image_path",
                                          str(tmp_path / "x.jpg"),
                                          "--model_path", path]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        webcam.main(webcam.load_args(["--det_model_path", path,
                                      "--video_path",
                                      str(tmp_path / "x.mp4")]))
    dirs = [str(tmp_path), str(tmp_path), str(tmp_path / "bb.pth")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pretrain_backbone.main(["--train_dir", dirs[0], "--gt_dir", dirs[1],
                                "--out", dirs[2]])
    for pretrain in (backbone_pretrain.pretrain_backbone,
                     backbone_pretrain.pretrain_backbone_dense):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pretrain(*dirs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(train.load_args(
            ["--config", str(tmp_path / "none.yaml"), "--epochs", "1",
             "--coordinator_address", "127.0.0.1:1", "--num_processes", "1",
             "--process_id", "0"]))
    assert not torch.distributed.is_initialized()
