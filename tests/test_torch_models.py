"""The PyTorch port's detector and weight carrier against the JAX package:
the same Flax weights go through ``DBTextModel.apply`` and, via
``weights.state_dict_from_jax``, through the port's ``DBTextModel``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu import utils as jax_utils
from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.models.head import fuse_variables as jax_fuse
from db_text_minimal_tpu.utils.torch_port import torch_state_dict_to_flax
from db_text_minimal_tpu_torch import utils
from db_text_minimal_tpu_torch.cli.common import load_model
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.models.head import fuse_variables
from db_text_minimal_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

ATOL = 5e-5   # the repo's model parity tolerance (tests/test_models.py)


@pytest.fixture(scope="module")
def jax_variables():
    """Flax init at 64×64 with every 1-D leaf (biases, BN scale, shift and
    statistics) moved by seeded noise, so that none is at its init value."""
    v = jax.device_get(JaxDBTextModel().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rs = np.random.RandomState(1)

    def nudge(a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        return (a + np.abs(rs.randn(*a.shape)) * 0.05).astype(a.dtype)

    return {"params": jax.tree.map(nudge, v["params"]),
            "batch_stats": jax.tree.map(nudge, v["batch_stats"])}


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(2, 64, 64, 3).astype(
        np.float32) * 2 - 1


@pytest.mark.parametrize("head", ["DBHead", "FusedDBHead"])
def test_model_matches_jax(head, jax_variables, images):
    variables = jax_variables if head == "DBHead" else jax_fuse(jax_variables)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JaxDBTextModel(head_name=head).apply(
            variables, jnp.asarray(images), train=False))
    model = DBTextModel(head_name=head).eval()
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(images)).numpy()
    assert out.shape == ref.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_state_dict_round_trip_is_exact(jax_variables):
    """state_dict_from_jax is the inverse of the JAX package's
    torch_state_dict_to_flax, deconvolution flip included."""
    sd = state_dict_from_jax(jax_variables["params"],
                             jax_variables["batch_stats"])
    params, stats = torch_state_dict_to_flax(sd, strict=True)
    for got, ref in ((params, jax_variables["params"]),
                     (stats, jax_variables["batch_stats"])):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_deconv_weight_layout(jax_variables):
    """A Flax (kh, kw, in, out) deconv kernel lands in torch's (in, out,
    kh, kw) layout spatially flipped."""
    k = jax_variables["params"]["segmentation_head"]["binarize"]["deconv1"][
        "kernel"]
    w = state_dict_from_jax(jax_variables["params"],
                            jax_variables["batch_stats"])[
        "segmentation_head.binarize.3.weight"].numpy()
    assert w.shape == (k.shape[2], k.shape[3], 2, 2)
    np.testing.assert_array_equal(w[:, :, 0, 1], k[1, 0])


def test_fused_head_weights_match_jax_fusion(jax_variables):
    sd = state_dict_from_jax(jax_variables["params"],
                             jax_variables["batch_stats"])
    fused = jax_fuse(jax_variables)
    ref = state_dict_from_jax(fused["params"], fused["batch_stats"])
    got = fuse_variables(sd)
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert torch.equal(got[key], ref[key]), key


def test_load_model_from_pth(tmp_path, jax_variables, images):
    """A .pth with the reference's key names loads fused on the CPU and
    gives the unfused model's output."""
    sd = state_dict_from_jax(jax_variables["params"],
                             jax_variables["batch_stats"])
    path = str(tmp_path / "model.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, path)
    fused = load_model(path, device="cpu", fuse_head=True)
    assert type(fused.segmentation_head).__name__ == "FusedDBHead"
    assert not fused.training
    plain = load_model(path, device="cpu")
    x = torch.from_numpy(images)
    with torch.no_grad():
        np.testing.assert_allclose(fused(x).numpy(), plain(x).numpy(),
                                   atol=1e-6)


def test_train_mode_not_ported():
    """Train mode is ported for DBHead, which then returns (P, T, B̂);
    FusedDBHead is an inference form and refuses it, as the JAX version
    asserts."""
    out = DBTextModel()(torch.zeros((1, 64, 64, 3)))
    assert out.shape == (1, 64, 64, 3)
    torch.testing.assert_close(out[..., 2], torch.sigmoid(
        50.0 * (out[..., 0] - out[..., 1])), rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="inference form"):
        DBTextModel(head_name="FusedDBHead")(torch.zeros((1, 64, 64, 3)))


def test_seeded_init():
    a, b = DBTextModel(), DBTextModel()
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.all(sa["segmentation_head.binarize.1.bias"] == 1e-4)
    assert torch.all(sa["segmentation_body.conv.1.bias"] == 0)


@pytest.mark.parametrize("shape", [(640, 640, 3), (480, 640, 3),
                                   (300, 200, 3)])
def test_test_resize_matches_jax(shape):
    img = np.random.RandomState(0).randint(0, 255, shape, np.uint8)
    np.testing.assert_array_equal(utils.test_resize(img, 640, pad=True),
                                  jax_utils.test_resize(img, 640, pad=True))
