"""The port's other detector families as whole models against the JAX
package on the CPU: deformable_resnet18 + FPN and resnet18 + FPEM_FFM in
eval and train mode, the weight carrier's round trip, and the loaders
and the handler (the train step is in ``test_torch_families_step.py``).
Helpers and the ``family`` fixture in ``torch_families``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu.utils.torch_port import torch_state_dict_to_flax
from db_text_minimal_tpu_torch.cli.common import (build_inference_forward,
                                                  load_model, neck_of)
from db_text_minimal_tpu_torch.serve.handler import DBTextDetectionHandler
from db_text_minimal_tpu_torch.utils import CAFFE_MEAN
from db_text_minimal_tpu_torch.weights import state_dict_from_jax
from test_torch_bf16 import _permute_layer1
from torch_families import ATOL, BATCH, SIZE, apply, family  # noqa: F401

torch.set_num_threads(1)

def test_eval_mode_matches_jax(family):
    """(P, T), NHWC, at atol 5e-5."""
    ref = apply(family["jax"], family["params"], family["stats"],
                jnp.asarray(family["x"]))
    with torch.no_grad():
        out = family["model"](torch.from_numpy(family["x"])).numpy()
    assert out.shape == ref.shape == (BATCH, SIZE, SIZE, 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_train_mode_matches_jax(family):
    """(P, T, B̂), NHWC. In train mode every BN divides by a statistic of
    its batch, down to 8 values a channel at c5, and B̂ = σ(50(P − T))
    multiplies the gap of P − T by up to 12.5: on random weights the JAX
    package lies ~1e-4 from itself when only the summation order of layer
    1 changes (``tests/test_torch_bf16.py``'s reordering, the same
    function). The port lies within 3 × that self-distance of JAX (mean
    abs, each channel; 1.5 × and 2.0 × measured), and its B̂ is
    σ(50(P − T)) of its own P and T."""
    x = jnp.asarray(family["x"])
    args = (family["params"], family["stats"])
    ref = apply(family["jax"], *args, x, train=True)
    other = _permute_layer1({"params": args[0], "batch_stats": args[1]})
    reordered = apply(family["jax"], other["params"],
                      other["batch_stats"], x, train=True)
    model = family["model"]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    try:
        with torch.no_grad():
            out = model(torch.from_numpy(family["x"])).numpy()
    finally:
        model.load_state_dict(state)
        model.eval()
    assert out.shape == ref.shape == (BATCH, SIZE, SIZE, 3)
    got = np.abs(out - ref).mean(axis=(0, 1, 2))
    noise = np.abs(reordered - ref).mean(axis=(0, 1, 2))
    assert (got <= 3 * noise).all(), (got, noise)
    assert (noise < 1e-4).all(), noise
    bhat = 1 / (1 + np.exp(-50 * (out[..., 0] - out[..., 1])))
    np.testing.assert_allclose(out[..., 2], bhat, rtol=0, atol=1e-6)


def test_state_dict_round_trip_is_exact(family):
    """``state_dict_from_jax`` is the inverse of the JAX package's
    ``torch_state_dict_to_flax`` on the new subtrees too."""
    sd = state_dict_from_jax(family["params"], family["stats"])
    params, stats = torch_state_dict_to_flax(sd, strict=True)
    for got, ref in ((params, family["params"]), (stats, family["stats"])):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
    if family["neck"] == "FPEM_FFM":
        dw = sd["segmentation_body.fpem_1.down_add3.depthwise_conv.weight"]
        assert tuple(dw.shape) == (128, 1, 3, 3)
        assert "segmentation_body.fpem_0.up_add1.pointwise_conv.bias" in sd
    else:
        assert tuple(sd["backbone.layer3.0.conv2.weight"].shape) == (
            256, 256, 3, 3)
        assert tuple(sd["backbone.layer3.0.conv2.offset_conv.weight"]
                     .shape) == (18, 256, 3, 3)


def test_loaders_and_handler_serve_every_family(family, tmp_path):
    """A family's ``.pth`` loads by ``load_model`` and
    ``build_inference_forward`` with only ``backbone`` given (the neck
    from the keys), fused or not, equal to the model; the handler serves
    a forward given to it in box mode; the folded modes refuse the
    family."""
    pth = str(tmp_path / "model.pth")
    torch.save(family["model"].state_dict(), pth)
    assert neck_of(family["model"].state_dict()) == family["neck"]
    x = torch.from_numpy(family["x"])
    with torch.no_grad():
        ref = family["model"](x).numpy()
        for fuse in (False, True):
            model = load_model(pth, device="cpu",
                               backbone=family["backbone"], fuse_head=fuse)
            np.testing.assert_allclose(model(x).numpy(), ref, atol=1e-6)
    _, forward = build_inference_forward(pth, backbone=family["backbone"],
                                         device="cpu")
    np.testing.assert_allclose(forward(family["x"]).numpy(), ref, atol=1e-6)
    with pytest.raises(ValueError, match="resnet18 \\+ FPN"):
        build_inference_forward(pth, backbone=family["backbone"],
                                infer_mode="folded", device="cpu")

    mean = torch.tensor(CAFFE_MEAN)
    handler = DBTextDetectionHandler(
        forward=lambda u8: forward(torch.from_numpy(u8).float() - mean),
        device="cpu")
    assert handler.initialized
    batch = np.random.RandomState(0).randint(0, 256, (2, SIZE, SIZE, 3),
                                             dtype=np.uint8)
    boxes = handler.postprocess_boxes(handler.inference(batch))
    assert len(boxes) == 2 and all("scores" in b for b in boxes)
