"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names; the reference loads nothing of the port; the command
refuses a machine without the card, and a checkout without the port, with
no result line."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

from portbench.core import harness

CHILD_RUN = """
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import tiny_context
from portbench.core import harness
reg, ctx = tiny_context("r18_serve_b32")
harness.run_cell(reg, ctx)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

CHILD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.model, portbench.reference.train
import portbench.reference.postprocess, portbench.reference.flops
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def _top_level_names(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code.format(
        root=str(ROOT), tests=str(ROOT / "portbench" / "tests"))],
        capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    names = _top_level_names(CHILD_RUN)
    assert "db_text_minimal_tpu_torch" in names
    assert not set(names) & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = _top_level_names(CHILD_REFERENCE)
    assert "db_text_minimal_tpu_torch" not in names
    assert not set(names) & set(harness.FORBIDDEN)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "db_text_minimal_tpu_torch_x", sys)
    assert "db_text_minimal_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert harness.forbidden_modules() == ["flax.core"]


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "r18_train_b16",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


def test_a_checkout_without_the_port_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
