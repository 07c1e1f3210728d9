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


def test_port_imports_with_jax_blocked():
    """Every module of the port, chip_smoke.py and compare_kernels.py
    import in a process where jax, flax, optax and the JAX package cannot
    be imported (this process already holds jax, so the check runs in a
    subprocess)."""
    snippet = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "db_text_minimal_tpu"):
    sys.modules[name] = None
import db_text_minimal_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke", "compare_kernels"]:
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
                   "cli.quality_bench", "cli.record_text_engine"):
        assert f"db_text_minimal_tpu_torch.{module}" in names
    assert int(count) >= 48


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
