"""The port's other detector modules against the JAX package on the CPU.

The deformable conv, the Bottleneck and the deep and deformable ResNets,
the FPEM_FFM neck and ``ConvHead``, each on the same numpy inputs from a
seed with the weights carried across by ``weights.state_dict_from_jax``,
in fp32 at atol 5e-5 under ``jax.default_matmul_precision("highest")``,
eval-mode BN statistics calibrated to the batch (``torch_families``).
The full models, their train step and the loaders are in
``test_torch_families_model.py``; init, pretrained backbones and pruning
in ``test_torch_families_load.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.models import fpn as jax_fpn
from db_text_minimal_tpu.models import head as jax_head
from db_text_minimal_tpu.models import resnet as jax_resnet
from db_text_minimal_tpu.models.deform import DeformConv as JaxDeformConv
from db_text_minimal_tpu_torch.models import DBTextModel, DeformConv
from db_text_minimal_tpu_torch.models.fpn import FPEM_FFM
from db_text_minimal_tpu_torch.models.head import ConvHead
from db_text_minimal_tpu_torch.models.resnet import (BACKBONE_OUT_CHANNELS,
                                                     BACKBONES, Bottleneck)
from db_text_minimal_tpu_torch.weights import state_dict_from_jax
from test_deform_oracle import _oracle_deform
from torch_families import (ATOL, HIGHEST, apply, calibrate, images,
                            jax_stats, nchw, nhwc, np_tree,
                            random_variables, zeros_input)

torch.set_num_threads(1)


def _load(module, params, stats, prefix):
    """Load the JAX subtree carried by ``state_dict_from_jax`` under the
    key ``prefix`` (e.g. ``backbone.layer2.0.conv2.``) into ``module``."""
    sd = state_dict_from_jax(params, stats)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                            if k.startswith(prefix)}, strict=True)
    return module


# ------------------------------------------------------------ DeformConv ----

def _deform_pair(stride, c=4, f=6, dtype=jnp.float32):
    """A JAX and a port ``DeformConv`` on the same weights, the offset
    branch random (offsets of several pixels), and a (2, 9, 10, c) input."""
    rs = np.random.RandomState(stride)
    x = rs.randn(2, 9, 10, c).astype(np.float32)
    jm = JaxDeformConv(f, stride=stride, dtype=dtype)
    params, _ = random_variables(jm, jnp.asarray(x), offset_scale=0.3)
    tree = {"backbone": {"layer2_0": {"conv2": params}}}
    pm = _load(DeformConv(c, f, stride), tree, {}, "backbone.layer2.0.conv2.")
    return x, jm, params, pm


def _offsets_in(jm, params, x, offsets):
    """The JAX conv's output with its offset branch's output replaced by
    ``offsets`` (N, OH, OW, 18), so that a gradient reaches them."""
    def intercept(next_fun, args, kwargs, context):
        if context.module.name == "offset_conv":
            return offsets
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(intercept):
        return jm.apply({"params": params}, x)


def _deform_grads(x, jm, params, pm, offsets):
    """(output, d/dx, d/doffsets, d/dkernel) of sum(out · G) in both
    packages, as NHWC / HWIO numpy arrays, and G."""
    n, h, w, _ = x.shape
    s = jm.stride
    g = np.random.RandomState(9).randn(
        n, (h + s - 1) // s, (w + s - 1) // s, jm.features).astype(
            np.float32)

    def jloss(x, offsets, kernel):
        return jnp.sum(_offsets_in(jm, dict(params, kernel=kernel), x,
                                   offsets) * g)

    with jax.default_matmul_precision(HIGHEST):
        out = np.asarray(jax.jit(lambda x, o: _offsets_in(jm, params, x, o))(
            jnp.asarray(x), jnp.asarray(offsets)))
        ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
            jnp.asarray(x), jnp.asarray(offsets),
            jnp.asarray(params["kernel"]))
    tx = torch.from_numpy(x).requires_grad_()
    to = torch.from_numpy(offsets).requires_grad_()
    hook = pm.offset_conv.register_forward_hook(
        lambda mod, inp, out: to.permute(0, 3, 1, 2))
    try:
        y = pm(tx.permute(0, 3, 1, 2))
    finally:
        hook.remove()
    (y * nchw(g)).sum().backward()
    got = (nhwc(y), tx.grad.numpy(), to.grad.numpy(),
           np.transpose(pm.weight.grad.numpy(), (2, 3, 1, 0)))
    return got, (out,) + tuple(np.asarray(r) for r in ref), g


def _check(got, ref):
    for name, a, b in zip(("out", "dx", "doffsets", "dkernel"), got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_matches_jax_and_the_oracle(stride):
    """Random offsets of several pixels, many taps outside the image: the
    output against JAX and the float64 oracle of
    ``tests/test_deform_oracle.py``, and the gradients with respect to
    the input, the offsets and the kernel against ``jax.grad``."""
    x, jm, params, pm = _deform_pair(stride)
    with torch.no_grad():
        offsets = nhwc(pm.offset_conv(nchw(x)))
    oh, ow = (9 + stride - 1) // stride, (10 + stride - 1) // stride
    assert offsets.shape == (2, oh, ow, 18)
    ys = (np.arange(oh) * stride)[None, :, None, None] + offsets[..., 0::2]
    assert (ys < -1).any() and (ys > 9).any(), "no tap leaves the image"
    got, ref, _ = _deform_grads(x, jm, params, pm, offsets)
    _check(got, ref)
    want = _oracle_deform(
        x.astype(np.float64),
        offsets.reshape(*offsets.shape[:3], 9, 2).astype(np.float64),
        np.asarray(params["kernel"], np.float64), stride)
    np.testing.assert_allclose(got[0], want, rtol=0, atol=ATOL)
    with torch.no_grad():   # the module with its own offset branch
        np.testing.assert_allclose(nhwc(pm(nchw(x))), got[0], rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_offset_gradient_at_zero_offsets(stride):
    """At the init every offset is zero and every tap samples an integer
    coordinate: the bilinear weight's derivative is one-sided there, and
    the port takes JAX's side (the lower corner's weight 1, the gradient
    the difference towards the next row or column)."""
    x, jm, params, pm = _deform_pair(stride)
    oh, ow = (9 + stride - 1) // stride, (10 + stride - 1) // stride
    got, ref, g = _deform_grads(x, jm, params, pm,
                                np.zeros((2, oh, ow, 18), np.float32))
    _check(got, ref)
    assert np.abs(ref[2]).max() > 0.1
    # the centre tap's dy at output (0, 0), by hand: row 1 minus row 0
    k = np.asarray(params["kernel"])[1, 1]                     # (C, F)
    by_hand = (x[0, 1, 0] - x[0, 0, 0]) @ k @ g[0, 0, 0]
    np.testing.assert_allclose(got[2][0, 0, 0, 8], by_hand, rtol=1e-5)


def test_deform_conv_bf16_matches_flax():
    """In bfloat16 the offsets and the sampling stay float32 and only the
    per-tap products and their sum run in bf16, as in flax: the output is
    bf16 and within a mean relative 1e-4 of flax's bf16 output on the same
    input, where the fp32 output lies over 10 × farther."""
    x, jm, params, pm = _deform_pair(1, c=64, f=32, dtype=jnp.bfloat16)
    ref16 = np.asarray(apply(jm, params, {}, jnp.asarray(x)), np.float32)
    ref32 = apply(JaxDeformConv(32), params, {}, jnp.asarray(x))
    pm.compute_dtype = torch.bfloat16
    with torch.no_grad():
        out = pm(nchw(x))
    assert out.dtype == torch.bfloat16
    scale = np.abs(ref16).mean()
    got = np.abs(nhwc(out.float()) - ref16).mean() / scale
    gap = np.abs(ref32 - ref16).mean() / scale
    assert got <= 1e-4 and got * 10 <= gap, (got, gap)


def test_deformable_convs_bf16_match_flax_on_its_inputs():
    """deformable_resnet18 in bf16: each of its six deformable convs
    (layer2..layer4), fed the JAX bf16 model's own input to it, gives the
    JAX conv's bf16 output within a mean relative 1e-4, as
    ``tests/test_torch_bf16.py`` holds the plain blocks. (A whole block is
    not comparable so: a bf16 rounding flip in conv1 moves the offsets,
    and so every sample, of the conv after it.)"""
    x = images()
    jm = jax_resnet.deformable_resnet18(dtype=jnp.bfloat16)
    params, stats = random_variables(jm, zeros_input())
    _, inter = jax.jit(lambda v, x: jm.apply(
        v, x, capture_intermediates=True, mutable=["intermediates"]))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
    inter = np_tree(inter["intermediates"])
    pm = _load(BACKBONES["deformable_resnet18"](), {"backbone": params},
               {"backbone": stats}, "backbone.")
    for stage in (2, 3, 4):
        for b in (0, 1):
            block = inter[f"layer{stage}_{b}"]
            conv = getattr(pm, f"layer{stage}")[b].conv2
            conv.compute_dtype = torch.bfloat16
            h = np.maximum(np.asarray(block["bn1"]["__call__"][0]), 0)
            want = np.asarray(block["conv2"]["__call__"][0], np.float32)
            with torch.no_grad():
                got = conv(nchw(h))
            assert got.dtype == torch.bfloat16
            rel = np.abs(nhwc(got.float()) - want).mean() / np.abs(
                want).mean()
            assert rel <= 1e-4, (stage, b, rel)


# ---------------------------------------------------------- backbones ----

def test_bottleneck_matches_jax():
    """One Bottleneck with its stride-2 downsample, eval and train mode."""
    x = np.random.RandomState(3).randn(2, 12, 10, 32).astype(np.float32)
    jm = jax_resnet.Bottleneck(planes=16, stride=2, downsample=True)
    params, stats = random_variables(jm, jnp.asarray(x))
    tree = {"backbone": {"layer1_0": params}}
    pm = _load(Bottleneck(32, 16, 2, downsample=True), tree,
               {"backbone": {"layer1_0": stats}}, "backbone.layer1.0.")
    calibrate(pm, nchw(x))
    stats = jax_stats(pm, "backbone.layer1.0", "backbone", "layer1_0")
    for train in (False, True):
        ref = apply(jm, params, stats, jnp.asarray(x), train)
        pm.train(train)
        with torch.no_grad():
            out = nhwc(pm(nchw(x)))
        assert out.shape == ref.shape == (2, 6, 5, 64)
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["resnet34", "resnet50",
                                  "deformable_resnet18",
                                  "deformable_resnet50"])
def test_backbone_matches_jax(name):
    """c2..c5 at 2×64×64, the deformable ones with random offsets."""
    x = images()
    jm = jax_resnet.BACKBONES[name]()
    params, stats = random_variables(jm, zeros_input())
    pm = _load(BACKBONES[name](), {"backbone": params}, {"backbone": stats},
               "backbone.")
    calibrate(pm, nchw(x))
    ref = apply(jm, params, jax_stats(pm, "backbone", "backbone"),
                jnp.asarray(x))
    with torch.no_grad():
        outs = pm(nchw(x))
    for o, r, c in zip(outs, ref, BACKBONE_OUT_CHANNELS[name]):
        assert o.shape[1] == c
        np.testing.assert_allclose(nhwc(o), r, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["resnet101", "resnet152"])
def test_deep_backbone_keys_and_shapes(name):
    """resnet101 and resnet152 are too slow to apply here: their
    state_dict keys and shapes against ``jax.eval_shape`` of the JAX
    init, carried by ``state_dict_from_jax``."""
    params, stats = random_variables(JaxDBTextModel(backbone_name=name),
                                     zeros_input())
    ref = state_dict_from_jax(params, stats)
    got = DBTextModel(backbone_name=name).state_dict()
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        assert tuple(got[key].shape) == tuple(value.shape), key
    blocks = {"resnet101": 33, "resnet152": 50}[name]
    assert sum(k.endswith(".conv3.weight") for k in got) == blocks


# ------------------------------------------------------- neck and head ----

def test_fpem_ffm_matches_jax_at_an_odd_size():
    """FPEM_FFM on resnet18's c2..c5 of a 72×88 image (18×22 down to
    3×3): the nearest resizes (3 to 5, 5 to 9, 6 to 11, ...) are not
    halvings. Eval and train mode."""
    rs = np.random.RandomState(4)
    feats = [rs.randn(2, h, w, c).astype(np.float32) for (h, w), c in zip(
        ((18, 22), (9, 11), (5, 6), (3, 3)), (64, 128, 256, 512))]
    jm = jax_fpn.FPEM_FFM()
    jfeats = [jnp.asarray(f) for f in feats]
    params, stats = random_variables(jm, jfeats)
    pm = _load(FPEM_FFM(), {"segmentation_body": params},
               {"segmentation_body": stats}, "segmentation_body.")
    assert pm.out_channels == 512
    tfeats = [nchw(f) for f in feats]
    calibrate(pm, tfeats)
    stats = jax_stats(pm, "segmentation_body", "segmentation_body")
    for train in (False, True):
        ref = apply(jm, params, stats, jfeats, train)
        pm.train(train)
        with torch.no_grad():
            out = nhwc(pm(tfeats))
        assert out.shape == ref.shape == (2, 18, 22, 512)
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_conv_head_matches_jax_and_the_model_refuses_it():
    """``ConvHead`` alone against JAX's; ``DBTextModel`` cannot build it in
    either package (JAX passes no ``out_channels``: a TypeError, ROADMAP
    queue 3 item 9; the port says so in a ValueError)."""
    x = np.random.RandomState(5).randn(2, 8, 8, 32).astype(np.float32)
    jm = jax_head.ConvHead(out_channels=3)
    params, _ = random_variables(jm, jnp.asarray(x))
    ref = apply(jm, params, {}, jnp.asarray(x))
    pm = _load(ConvHead(32, 3), {"segmentation_head": params}, {},
               "segmentation_head.")
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(pm(nchw(x))), ref, rtol=0,
                                   atol=ATOL)
    with pytest.raises(TypeError):
        JaxDBTextModel(head_name="ConvHead").init(jax.random.PRNGKey(0),
                                                  zeros_input())
    with pytest.raises(ValueError, match="ConvHead"):
        DBTextModel(head_name="ConvHead")
