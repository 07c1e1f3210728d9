"""The PyTorch port's BN-folded and int8 inference forward against the JAX
package's ``models/quant_infer.py``, and the P1 epilogue's plain version
against the TPU kernel ``_epi_kernel`` of ``benchmarks/int8_conv_probe.py``
run in Pallas' interpret mode.

Weights are a Flax init with every 1-D leaf moved by seeded noise (so that
BN folding is not the identity), carried into a torch state_dict by
``weights.state_dict_from_jax``; the JAX package's folded trees are carried
into the port's by ``weights.quant_vars_from_jax``.

Two kinds of whole-forward comparison. In f32, the float convs of the two
packages sum in different orders; an ulp of difference moves an int8
activation across a rounding boundary now and then, and random weights
carry such a flip on to many positions of the later int8 convs, so the f32
comparison is held to measured bounds. With the float convs computed in f64
on both sides (and rounded to f32 after, as both forwards do), every int8
activation is equal and the maps agree within 1e-6: the int8 path itself
(quantization, convolution, epilogue, fusion) is exact.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.models import quant_infer as JQ
from db_text_minimal_tpu.models.head import fuse_variables as jax_fuse
from db_text_minimal_tpu_torch.models import quant_infer as Q
from db_text_minimal_tpu_torch.ops import int8 as I
from db_text_minimal_tpu_torch.weights import (quant_vars_from_jax,
                                               state_dict_from_jax)

torch.set_num_threads(1)

ATOL = 5e-5   # the repo's model parity tolerance (tests/test_models.py)
PROBE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "int8_conv_probe.py")


@pytest.fixture(scope="module")
def jax_variables():
    """Flax init in the FusedDBHead layout, every 1-D leaf nudged."""
    v = jax.device_get(JaxDBTextModel().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rs = np.random.RandomState(1)

    def nudge(a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        return (a + np.abs(rs.randn(*a.shape)) * 0.05).astype(a.dtype)

    return jax_fuse({"params": jax.tree.map(nudge, v["params"]),
                     "batch_stats": jax.tree.map(nudge, v["batch_stats"])})


@pytest.fixture(scope="module")
def state_dict(jax_variables):
    """The same weights as a port state_dict (FusedDBHead keys)."""
    return state_dict_from_jax(jax_variables["params"],
                               jax_variables["batch_stats"])


def _images(size: int) -> np.ndarray:
    return np.random.RandomState(0).rand(2, size, size, 3).astype(
        np.float32) * 2 - 1


def _forward(qvars, x, **kw) -> np.ndarray:
    with torch.inference_mode():
        return Q.quant_dbnet_forward(qvars, torch.from_numpy(x), **kw).numpy()


# ------------------------------------------------------------------ P1 ----

def _probe_kernel():
    """``_epi_kernel`` and ``ACT_SCALE`` from the probe's source: importing
    the probe would allocate its 16x160x160x256 input."""
    tree = ast.parse(open(PROBE).read())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name == "_epi_kernel")
            or (isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "ACT_SCALE"
                        for t in n.targets))]
    ns = {"jnp": jnp}
    exec(compile(ast.Module(body=keep, type_ignores=[]), PROBE, "exec"), ns)
    return ns["_epi_kernel"], ns["ACT_SCALE"]


@pytest.mark.parametrize("shape", [(2, 8, 12, 128), (1, 6, 10, 256)])
def test_epilogue_plain_matches_probe_kernel(shape):
    """P1's int8 form against the TPU kernel in interpret mode, on the
    probe's grid (N, ceil(H/4)) of (1, 4, W, C) blocks (H = 6 leaves a
    ragged block); the first row's accumulators land on exact .5 ties of
    y / ACT_SCALE (eff = 2^-6: y * 31.75 = acc * 127/256), which both round
    to even."""
    kernel, act_scale = _probe_kernel()
    n, h, w, c = shape
    rs = np.random.RandomState(c)
    y = rs.randint(-2 ** 15, 2 ** 15, shape).astype(np.int32)
    eff = (rs.rand(c) * 4e-4).astype(np.float32)
    bias = (rs.randn(c) * 0.5).astype(np.float32)
    y[0, 0] = (128 * (2 * rs.randint(0, 4, (w, c)) + 1)).astype(np.int32)
    eff[: c // 2] = 2.0 ** -6
    bias[: c // 2] = 0.0
    spec = pl.BlockSpec((1, 4, w, c), lambda i, j: (i, j, 0, 0))
    vspec = pl.BlockSpec((c,), lambda i, j: (0,))
    ref = np.asarray(pl.pallas_call(
        kernel, grid=(n, pl.cdiv(h, 4)), in_specs=[spec, vspec, vspec],
        out_specs=spec, out_shape=jax.ShapeDtypeStruct(shape, jnp.int8),
        interpret=True)(jnp.asarray(y), jnp.asarray(eff),
                        jnp.asarray(bias)))
    got = I.int8_epilogue(torch.from_numpy(y.reshape(-1, c)),
                          torch.from_numpy(eff), torch.from_numpy(bias), True,
                          torch.tensor(act_scale, dtype=torch.float32))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy().reshape(shape), ref)
    ties = y[0, 0, :, : c // 2].astype(np.float64) * 127 / 256
    assert np.all(ties % 1 == 0.5)
    np.testing.assert_array_equal(ref[0, 0, :, : c // 2],
                                  np.clip(np.round(ties), -127, 127))


@pytest.mark.parametrize("relu", [True, False])
def test_epilogue_forms_match_fconv_arithmetic(relu):
    """The f32 form against the JAX forward's epilogue (``_fconv``,
    quant_infer.py:243: ``y.astype(f32) * (sx * eff) + bias``, relu), and
    the int8 form against that requantized as the next conv quantizes its
    input (quant_infer.py:237): both exact, over accumulators spanning a
    real conv's int32 range."""
    rs = np.random.RandomState(7)
    acc = rs.randint(-2 ** 24, 2 ** 24, (300, 256)).astype(np.int32)
    sx = np.float32(0.0123)
    eff = (rs.rand(256) * 1e-3).astype(np.float32)
    bias = rs.randn(256).astype(np.float32)
    scale = np.array(jnp.asarray(sx) * jnp.asarray(eff))
    ref = jnp.asarray(acc).astype(jnp.float32) * scale + jnp.asarray(bias)
    if relu:
        ref = jax.nn.relu(ref)
    got = I.int8_epilogue(torch.from_numpy(acc),
                          torch.from_numpy(scale),
                          torch.from_numpy(bias), relu)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    out_scale = np.float32(np.abs(np.asarray(ref)).max() / 127 * 0.8)
    ref_q = jnp.clip(jnp.round(ref * (1.0 / jnp.asarray(out_scale))), -127,
                     127).astype(jnp.int8)
    got_q = I.int8_epilogue(torch.from_numpy(acc),
                            torch.from_numpy(scale),
                            torch.from_numpy(bias), relu,
                            torch.tensor(out_scale))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    assert np.abs(np.asarray(ref_q)).max() == 127


def test_epilogue_refuses_what_the_kernel_does_not_take():
    acc = torch.zeros((8, 12), dtype=torch.int32)
    s = torch.ones(12)
    with pytest.raises(ValueError, match="multiple of 4"):
        I.int8_epilogue(acc[:, :10].contiguous(), s[:10], s[:10], True)
    with pytest.raises(ValueError, match="contiguous"):
        I.int8_epilogue(torch.zeros((12, 8), dtype=torch.int32).t(), s, s,
                        True)
    with pytest.raises(TypeError, match="int32"):
        I.int8_epilogue(acc.float(), s, s, True)
    with pytest.raises(TypeError, match="f32"):
        I.int8_epilogue(acc, s.double(), s, True)


def test_cpu_epilogue_counts_no_launch():
    I.reset_launches()
    I.int8_epilogue(torch.zeros((4, 8), dtype=torch.int32), torch.ones(8),
                    torch.zeros(8), True, torch.tensor(1.0))
    assert set(I.LAUNCHES.values()) == {0}


def test_quantization_matches_jax():
    """The dynamic scale and the per-tensor quantization against the JAX
    expressions (quant_infer.py:236-237), exact, with values on .5 ties of
    x / sx; an all-zero tensor takes the 1e-6 floor."""
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 9, 9, 64) * 3).astype(np.float32)
    ref_sx = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(x))), 1e-6) / 127.0
    x.reshape(-1)[:200] = ((np.arange(200) - 100 + 0.5)
                           * np.float32(ref_sx)).astype(np.float32)
    for arr in (x, np.zeros_like(x)):
        sx = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(arr))), 1e-6) / 127.0
        ref_q = jnp.clip(jnp.round(jnp.asarray(arr) * (1.0 / sx)), -127,
                         127).astype(jnp.int8)
        got_sx = I.dynamic_scale(torch.from_numpy(arr))
        assert got_sx.dtype == torch.float32 and got_sx.dim() == 0
        assert got_sx.item() == float(sx)
        got_q = I.quantize_per_tensor(torch.from_numpy(arr), got_sx)
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))


@pytest.mark.parametrize("k,stride,pad", [
    (3, 1, 1), (3, 2, 1), (1, 2, 0), (1, 1, 0), (3, 1, 0)])
def test_int8_conv2d_matches_jax(k, stride, pad):
    """im2col + ``torch._int_mm`` against ``conv_general_dilated(int8,
    int8, preferred_element_type=int32)``, exact."""
    rs = np.random.RandomState(k * 10 + stride)
    q = rs.randint(-127, 128, (2, 11, 9, 64)).astype(np.int8)
    w = rs.randint(-127, 128, (k, k, 64, 128)).astype(np.int8)   # HWIO
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(q), jnp.asarray(w), (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    w_cols = torch.from_numpy(np.ascontiguousarray(
        w.transpose(3, 0, 1, 2))).reshape(128, -1)
    got = I.int8_conv2d(torch.from_numpy(q), w_cols, k, stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------ folded trees -----

VARIANTS = {
    "folded": dict(min_out_channels=10 ** 9),
    "int8": dict(skip=()),
    "int8_default_skip": dict(),
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}/{key}")
    else:
        yield path, tree


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prepare_quant_params_matches_jax(variant, jax_variables,
                                          state_dict):
    """The port's folding and quantization of the state_dict against the
    JAX package's tree carried over: the same leaves, int8 kernels equal,
    f32 leaves within 1 ulp (the folding repeats the JAX numpy op order),
    and the same convs int8: 17 with skip=() (layers 2-4, the FPN output
    conv, the head's conv1), 16 under the default skip, none folded."""
    kw = VARIANTS[variant]
    got = dict(_leaves(Q.prepare_quant_params(state_dict, **kw)))
    ref = dict(_leaves(quant_vars_from_jax(
        JQ.prepare_quant_params(jax_variables, **kw))))
    assert sorted(got) == sorted(ref)
    for path, value in ref.items():
        assert got[path].dtype == value.dtype, path
        assert got[path].shape == value.shape, path
        if value.dtype == torch.int8:
            assert torch.equal(got[path], value), path
        else:
            np.testing.assert_array_max_ulp(got[path].numpy(),
                                            value.numpy(), maxulp=1)
    int8 = sorted(p for p, v in got.items() if v.dtype == torch.int8)
    want = {"folded": 0, "int8": 17, "int8_default_skip": 16}[variant]
    assert len(int8) == want
    if want:
        assert "/params/segmentation_body/conv/kernel" in int8
        assert ("/params/segmentation_head/conv1/kernel" in int8) == (
            want == 17)
        assert all("layer1" not in p and "reduce" not in p
                   and "smooth" not in p for p in int8)


def test_folded_forward_matches_jax(jax_variables, state_dict):
    """The BN-folded forward in f32, both maps and prob-only, against the
    JAX folded forward (atol 5e-5); prob-only is the first map, exactly."""
    x = _images(64)
    qv = Q.prepare_quant_params(state_dict, min_out_channels=10 ** 9)
    jq = JQ.prepare_quant_params(jax_variables, min_out_channels=10 ** 9)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JQ.quant_dbnet_forward(jq, jnp.asarray(x)))
    got = _forward(qv, x)
    assert got.shape == ref.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    prob = _forward(qv, x, prob_only=True)
    assert prob.shape == (2, 64, 64, 1)
    np.testing.assert_array_equal(prob[..., 0], got[..., 0])


def test_prob_only_is_the_first_map_in_int8(state_dict):
    x = _images(64)
    qv = Q.prepare_quant_params(state_dict, skip=())
    np.testing.assert_array_equal(_forward(qv, x, prob_only=True)[..., 0],
                                  _forward(qv, x)[..., 0])


def _jax_int8_run(jq, x):
    """The JAX forward with every int8 conv's int8 input recorded."""
    recorded = []
    conv = jax.lax.conv_general_dilated

    def recording(lhs, rhs, *args, **kwargs):
        if lhs.dtype == jnp.int8:
            recorded.append(np.asarray(lhs))
        return conv(lhs, rhs, *args, **kwargs)

    jax.lax.conv_general_dilated = recording
    try:
        out = np.asarray(JQ.quant_dbnet_forward(jq, jnp.asarray(x)))
    finally:
        jax.lax.conv_general_dilated = conv
    return out, recorded


@pytest.fixture
def f64_float_convs(monkeypatch):
    """Both forwards' float convs in f64 (their outputs rounded to f32, as
    both forwards do): summation order stops mattering."""
    monkeypatch.setattr(JQ, "_compute_dtype", lambda: jnp.float64)
    with jax.enable_x64(True):
        yield torch.float64


@pytest.mark.parametrize("scales", ["dynamic", "static"])
def test_int8_forward_matches_jax_exactly(scales, jax_variables,
                                          f64_float_convs):
    """The int8 forward (skip=(): 17 int8 convs) against the JAX one on the
    carried tree, dynamic scales and static ones calibrated by the JAX
    package, with the float convs in f64 on both sides: every int8
    activation equal, the maps within 1e-6 (measured: 6e-8, the sigmoid's
    ulps)."""
    x = _images(128)
    jq = JQ.prepare_quant_params(jax_variables, skip=())
    if scales == "static":
        jq = JQ.calibrate_activation_scales(jq, [x[:1]])
    ref, ref_q = _jax_int8_run(jq, x)
    got_q = []
    got = _forward(quant_vars_from_jax(jq), x, compute_dtype=f64_float_convs,
                   int8_inputs=got_q)
    assert len(got_q) == len(ref_q) == 17
    for a, b in zip(got_q, ref_q):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_calibration_matches_jax(jax_variables, state_dict, f64_float_convs):
    """Static scales calibrated by the port on its own tree equal the JAX
    package's (float convs in f64 on both sides), on all 17 int8 convs in
    forward order."""
    x = _images(128)
    jq = JQ.calibrate_activation_scales(
        JQ.prepare_quant_params(jax_variables, skip=()), [x[:1], x[1:]])
    qv = Q.calibrate_activation_scales(
        Q.prepare_quant_params(state_dict, skip=()), [x[:1], x[1:]],
        compute_dtype=f64_float_convs)
    ref = np.asarray([n["act_scale"]
                      for n in JQ._forward_conv_order(jq["params"])],
                     np.float32)
    got = np.asarray([n["act_scale"].item()
                      for n in Q._forward_conv_order(qv["params"])],
                     np.float32)
    assert len(got) == len(ref) == 17
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


@pytest.mark.parametrize("scales", ["dynamic", "static"])
def test_int8_forward_in_f32_tracks_jax(scales, jax_variables):
    """The same comparison in f32, each package's own convs: the first
    int8 conv's input differs at a few positions of 131072 (measured: 2
    dynamic, 3 static), and the flips that random weights carry on leave
    the maps within a mean of 0.01 (measured: 0.0065, 0.0061)."""
    x = _images(128)
    jq = JQ.prepare_quant_params(jax_variables, skip=())
    if scales == "static":
        jq = JQ.calibrate_activation_scales(jq, [x[:1]])
    ref, ref_q = _jax_int8_run(jq, x)
    got_q = []
    got = _forward(quant_vars_from_jax(jq), x, int8_inputs=got_q)
    assert (got_q[0].numpy() != ref_q[0]).mean() < 1e-4
    assert np.abs(got - ref).mean() < 0.01


def _count_forms(monkeypatch):
    forms = []
    real = Q.int8_conv

    def counting(q, w_cols, k, stride, pad, scale, bias, relu,
                 out_scale=None):
        forms.append("f32" if out_scale is None else "int8")
        return real(q, w_cols, k, stride, pad, scale, bias, relu, out_scale)

    monkeypatch.setattr(Q, "int8_conv", counting)
    return forms


@pytest.mark.parametrize("skip", ["none", "default"])
def test_fused_and_unfused_static_forwards_are_bit_equal(skip, state_dict,
                                                         monkeypatch):
    """With static scales P1 writes the next conv's int8 input where an
    int8 conv feeds one after relu: 7 places with skip=() (conv1 -> conv2 of
    the 6 blocks of layers 2-4, the FPN output conv -> the head's conv1), 6
    under the default skip; every other int8 conv, and every one at
    dynamic scales, ends in the f32 form. Fused and unfused forwards give
    the same bits."""
    x = _images(64)
    qv = Q.prepare_quant_params(
        state_dict, **({"skip": ()} if skip == "none" else {}))
    forms = _count_forms(monkeypatch)
    _forward(qv, x)
    assert forms.count("f32") == (17 if skip == "none" else 16)
    assert "int8" not in forms
    qv = Q.calibrate_activation_scales(qv, [x])
    runs = []
    for fuse in (True, False):
        forms.clear()
        inputs = []
        runs.append((_forward(qv, x, fuse=fuse, int8_inputs=inputs), inputs,
                     sorted(forms)))
    (fused, fused_q, fused_forms), (plain, plain_q, plain_forms) = runs
    n_fused = 7 if skip == "none" else 6
    assert fused_forms.count("int8") == n_fused
    assert fused_forms.count("f32") == 10
    assert plain_forms.count("f32") == 10 + n_fused
    np.testing.assert_array_equal(fused, plain)
    assert len(fused_q) == len(plain_q)
    assert all(torch.equal(a, b) for a, b in zip(fused_q, plain_q))


def test_int8_forward_tracks_the_float_forward(state_dict):
    """As the JAX package's test (test_pallas_ops.py:315-320): the int8
    forward, dynamic and calibrated, within a mean of 0.02 of the folded
    float forward."""
    x = _images(128)
    base = _forward(Q.prepare_quant_params(state_dict,
                                           min_out_channels=10 ** 9), x)
    qv = Q.prepare_quant_params(state_dict)
    assert np.abs(_forward(qv, x) - base).mean() < 0.02
    qv = Q.calibrate_activation_scales(qv, [x])
    assert np.abs(_forward(qv, x) - base).mean() < 0.02


@pytest.mark.parametrize("quant_head", [False, True])
def test_make_quant_forward_matches_jax(quant_head, tmp_path, monkeypatch,
                                        f64_float_convs):
    """The quality bench's ``--quant`` forward from a CPU trainer's seeded
    weights on ``data.scenes`` batches (uint8 images): calibrated on the
    first batch's first 2 images, mean-subtracted; the head quantized only
    with ``--quant_head``. Against the JAX package's chain (the same weights
    through ``torch_state_dict_to_flax``, ``fuse_variables``,
    ``prepare_quant_params``, ``calibrate_activation_scales``), float convs
    in f64 on both sides: the same scales, maps within 1e-6."""
    from db_text_minimal_tpu.utils import CAFFE_MEAN
    from db_text_minimal_tpu.utils.torch_port import torch_state_dict_to_flax
    from db_text_minimal_tpu_torch.cli import quality_bench as qb
    from db_text_minimal_tpu_torch.data.scenes import text_batch
    from db_text_minimal_tpu_torch.train.trainer import Trainer, to_device

    monkeypatch.setattr(Q, "_compute_dtype", lambda device: f64_float_convs)
    args = qb.load_args(["--data_dir", str(tmp_path), "--out", "x.json",
                         "--img_size", "64", "--device", "cpu", "--quant"]
                        + (["--quant_head"] if quant_head else []))
    cfg = qb.build_cfg(args)
    cfg.logging.logger_file = None
    trainer = Trainer(cfg)
    state = trainer.init_state()
    loader = [text_batch(40 + i, 3, 64) for i in range(2)]
    assert loader[0]["img"].dtype == np.uint8
    forward = qb.make_quant_forward(trainer, state, loader, args)
    got = forward(to_device(loader[1], trainer.device)).numpy()

    params, stats = torch_state_dict_to_flax(state.model.state_dict(),
                                             strict=True)
    jq = JQ.prepare_quant_params(
        jax_fuse({"params": params, "batch_stats": stats}),
        skip=() if quant_head else JQ.DEFAULT_SKIP)
    mean = np.asarray(CAFFE_MEAN, np.float32)
    jq = JQ.calibrate_activation_scales(
        jq, [loader[0]["img"][:2].astype(np.float32) - mean])
    ref = np.asarray(JQ.quant_dbnet_forward(
        jq, jnp.asarray(loader[1]["img"].astype(np.float32) - mean)))
    n_int8 = len(JQ._forward_conv_order(jq["params"]))
    assert n_int8 == (17 if quant_head else 16)
    assert got.shape == ref.shape == (3, 64, 64, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # the full_eval rows run on the quantized forward
    out = qb.full_eval(trainer, state, loader[:1], args, forward=forward)
    assert set(out) >= {"host", "device"} and out["n_test_images"] == 3
