"""The port's reader of the JAX package's Flax msgpack checkpoints
(``train/flax_msgpack``, ``train/checkpoints.load_params_any``) against
``flax.serialization`` on the CPU: the decoded tree equals
``msgpack_restore``'s leaf for leaf (values, dtypes, shapes, bit for bit);
a JAX ``Trainer``-style checkpoint of the full-width resnet18 detector gives
the port's model the JAX forward at atol 5e-5 (the repo's model parity
tolerance); the committed fixture of ``tests/make_flax_fixture.py`` is what
the script writes, byte for byte, and the port reproduces its maps."""

import filecmp
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from db_text_minimal_tpu.config import default_config as jax_default_config
from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.train.checkpoints import \
    save_checkpoint as jax_save_checkpoint
from db_text_minimal_tpu.train.trainer import \
    make_optimizer as jax_make_optimizer
from db_text_minimal_tpu_torch.cli.common import load_model
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.train import flax_msgpack
from db_text_minimal_tpu_torch.train.checkpoints import load_params_any

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_flax_fixture  # noqa: E402
from torch_tools import random_detector_variables  # noqa: E402

ATOL = 5e-5


def assert_same_tree(ref, got, path="") -> int:
    """``got`` (the port's decode) equals ``ref`` (flax's) leaf for leaf;
    returns the number of leaves."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        return sum(assert_same_tree(ref[k], got[k], f"{path}/{k}")
                   for k in ref)
    if isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        return sum(assert_same_tree(r, g, f"{path}[{i}]")
                   for i, (r, g) in enumerate(zip(ref, got)))
    if str(getattr(ref, "dtype", "")) == "bfloat16":
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(ref), path
        np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                      np.asarray(ref).view(np.uint16))
        return 1
    assert type(got) is type(ref), (path, type(got), type(ref))
    if isinstance(ref, (np.ndarray, np.generic)):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(got, ref, err_msg=path)
    else:
        assert got == ref, path
    return 1


@pytest.fixture(scope="module")
def trainer_ckpt(tmp_path_factory):
    """A JAX checkpoint as the JAX ``Trainer``'s policy writes it: the
    full-width resnet18 + FPN + DBHead variables, the optax state of
    ``make_optimizer`` after one update, and the step."""
    model = JaxDBTextModel()
    variables = random_detector_variables(model, (1, 64, 64, 3))
    tx = jax_make_optimizer(jax_default_config())
    opt_state = tx.init(variables["params"])
    grads = jax.tree.map(lambda p: jnp.full_like(p, 1e-3),
                         variables["params"])
    _, opt_state = tx.update(grads, opt_state, variables["params"])
    path = str(tmp_path_factory.mktemp("flax") / "last_cp.ckpt")
    jax_save_checkpoint(path, {"params": variables["params"],
                               "batch_stats": variables["batch_stats"],
                               "opt_state": opt_state,
                               "step": jnp.asarray(7, jnp.int32)},
                        {"epoch": 0})
    return path, model, variables


def _leaves_blob(monkeypatch, case: str) -> bytes:
    rs = np.random.RandomState(3)
    if case == "leaves":
        tree = {"f32": np.float32(1.5), "f64": np.float64(-2.25),
                "i64": np.int64(-(2 ** 40)), "u8": np.uint8(200),
                "bool": np.bool_(True), "complex": 3.0 - 0.5j,
                "py": {"int": 7, "neg": -100000, "big": 2 ** 40,
                       "float": 0.1, "str": "text", "none": None,
                       "true": True, "list": [1, 2.5, "x"]},
                "bf16": jnp.asarray(rs.randn(3, 5), jnp.bfloat16),
                "bf16_scalar": jnp.bfloat16(1.25),
                "i8": rs.randint(-128, 127, (4, 2)).astype(np.int8),
                "empty": np.zeros((0, 3), np.float32),
                "wide": rs.randn(2, 70000).astype(np.float32)}
        return serialization.msgpack_serialize(tree)
    # arrays over flax's chunk size go as __msgpack_chunked_array__ maps
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"a": rs.randn(7, 9).astype(np.float32),
            "nested": {"b": rs.randint(0, 9, (100,)).astype(np.int64),
                       "bf16": jnp.asarray(rs.randn(6, 11), jnp.bfloat16),
                       "small": np.arange(3, dtype=np.int16)}}
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    return blob


@pytest.mark.parametrize("case", ["trainer", "leaves", "chunked"])
def test_reader_matches_flax_msgpack_restore(trainer_ckpt, monkeypatch,
                                             case):
    if case == "trainer":
        with open(trainer_ckpt[0], "rb") as f:
            blob = f.read()
    else:
        blob = _leaves_blob(monkeypatch, case)
    ref = serialization.msgpack_restore(blob)
    got = flax_msgpack.msgpack_restore(blob)
    leaves = assert_same_tree(ref, got)
    assert leaves >= {"trainer": 100, "leaves": 21, "chunked": 4}[case]
    if case == "trainer":
        assert set(got) == {"params", "batch_stats", "opt_state", "step"}


def test_full_width_jax_ckpt_gives_the_jax_forward(trainer_ckpt):
    """``load_params_any`` returns the model's state_dict alone; the port's
    model on it gives the JAX model's maps at atol 5e-5."""
    path, model, variables = trainer_ckpt
    sd = load_params_any(path)
    assert sd.keys() == DBTextModel().state_dict().keys()
    x = np.random.RandomState(1).uniform(-120, 120,
                                         (2, 64, 96, 3)).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    port = load_model(path, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert 0.01 < ref[..., 0].mean() < 0.99
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_fixture_script_recreates_the_committed_files(tmp_path):
    """``make_flax_fixture.py`` writes the committed files byte for byte;
    the port loads the committed checkpoint with its widths sidecar and
    gives its committed JAX maps at atol 5e-5."""
    written = make_flax_fixture.main(str(tmp_path))
    for path in written:
        committed = os.path.join(make_flax_fixture.DEFAULT_DIR,
                                 os.path.basename(path))
        assert filecmp.cmp(path, committed, shallow=False), committed
    total = sum(os.path.getsize(p) for p in written)
    assert total < 2 * 2 ** 20
    ckpt = os.path.join(make_flax_fixture.DEFAULT_DIR, "flax_det.ckpt")
    port = load_model(ckpt, device="cpu")
    assert port.segmentation_head.binarize[0].weight.shape[0] == \
        make_flax_fixture.WIDTHS["head_width"]
    with torch.no_grad():
        got = port(torch.from_numpy(make_flax_fixture.fixture_input()))
    ref = np.load(os.path.join(make_flax_fixture.DEFAULT_DIR,
                               "flax_det_maps.npy"))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
