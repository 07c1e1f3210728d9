"""The port's weight-exact rewrites of the folded and int8 forwards
(``stem_s2d``, ``deconv_d2s`` in ``models/quant_infer.py``) against the JAX
package's, and the public helpers ``metrics.cal_text_score``,
``utils.timer`` and ``utils.pad_to_multiple`` against theirs.

The rewrites' kernels are derived from the port's own layouts (OIHW
convs, ``ConvTranspose2d``'s (in, out, kh, kw) deconvs); each is held to
the JAX package's after the layout conversion, exactly, and to the plain
conv or transposed conv it replaces. The folded trees, with each rewrite
and both, are held leaf for leaf to the JAX package's carried by
``weights.quant_vars_from_jax``, and the forwards to the JAX forwards with
the same flags, at ``tests/test_torch_quant.py``'s tolerances: folded in
f32 at 5e-5; int8 with the float convs in f64 on both sides, every int8
activation equal and the maps within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from db_text_minimal_tpu import utils as jax_utils
from db_text_minimal_tpu.cli import common as jax_common
from db_text_minimal_tpu.metrics import pixel as jax_pixel
from db_text_minimal_tpu.models import quant_infer as JQ
from db_text_minimal_tpu_torch import utils as port_utils
from db_text_minimal_tpu_torch.cli.common import make_folded_forward
from db_text_minimal_tpu_torch.metrics import RunningScore, cal_text_score
from db_text_minimal_tpu_torch.models import quant_infer as Q
from db_text_minimal_tpu_torch.weights import _kernel, quant_vars_from_jax
from test_torch_quant import (ATOL, _forward, _jax_int8_run,  # noqa: F401
                              _leaves, f64_float_convs, jax_variables,
                              state_dict)

FLAGS = {"s2d": dict(stem_s2d=True), "d2s": dict(deconv_d2s=True),
         "both": dict(stem_s2d=True, deconv_d2s=True)}
MODES = {"folded": dict(min_out_channels=10 ** 9), "int8": dict(skip=())}
SIZE = 64
# the int8 stem: Cout 64 and Cin 12 fall under the default thresholds
# (min_out_channels=128, min_in_channels=64), so both are lowered; the
# 64-channel convs of layer 1, the FPN and the head's conv1 go int8 too
INT8_STEM = dict(stem_s2d=True, min_out_channels=64, min_in_channels=1)


def _images(size: int = SIZE) -> np.ndarray:
    return np.random.RandomState(5).rand(2, size, size, 3).astype(
        np.float32) * 2 - 1


def _oihw(hwio: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(hwio, (3, 2, 0, 1)))


# ------------------------------------------------------------ helpers ----

@pytest.mark.parametrize("helper", ["space_to_depth", "depth_to_space",
                                    "s2d_stem_kernel", "d2s_deconv_kernel"])
def test_rewrite_helpers_match_jax(helper):
    """Each of the four helpers against the JAX package's after the layout
    conversion (HWIO -> OIHW; a JAX deconv kernel through ``_kernel``):
    exactly."""
    rs = np.random.RandomState(11)
    if helper in ("space_to_depth", "depth_to_space"):
        x = rs.randn(2, 6, 10, 12).astype(np.float32)
        ref = np.asarray(getattr(JQ, "_" + helper)(jnp.asarray(x)))
        got = getattr(Q, "_" + helper)(torch.from_numpy(x)).numpy()
        assert got.shape == ref.shape
    elif helper == "s2d_stem_kernel":
        k7 = rs.randn(7, 7, 3, 64).astype(np.float32)   # HWIO
        ref = _oihw(JQ._s2d_stem_kernel(k7))
        got = Q._s2d_stem_kernel(_oihw(k7))
        assert got.shape == (64, 12, 4, 4)
    else:
        k = rs.randn(2, 2, 64, 5).astype(np.float32)    # flax deconv
        ref = _oihw(JQ._d2s_deconv_kernel(k))
        got = Q._d2s_deconv_kernel(np.ascontiguousarray(_kernel(k, True)))
        assert got.shape == (20, 64, 1, 1)
    np.testing.assert_array_equal(got, ref)


def test_space_to_depth_inverts():
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 8, 4, 5))
    s2d = Q._space_to_depth(x)
    assert s2d.shape == (3, 4, 2, 20)
    torch.testing.assert_close(s2d[0, 1, 1, 5:10], x[0, 2, 3], rtol=0,
                               atol=0)   # (dy, dx) = (0, 1)
    assert torch.equal(Q._depth_to_space(s2d), x)


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 1), (37, 5)])
def test_d2s_deconv_matches_conv_transpose(cin, cout):
    """The ``deconv_d2s`` form (1x1 product, depth-to-space, bias) against
    ``F.conv_transpose2d`` at stride 2 on the (in, out, 2, 2) kernel it
    came from, tap for tap (atol 1e-6), at the head's two deconvs and one
    odd, pruned width."""
    rs = np.random.RandomState(cin + cout)
    x = torch.from_numpy(rs.randn(2, 9, 7, cin).astype(np.float32))
    w = (rs.randn(cin, cout, 2, 2) / np.sqrt(cin)).astype(np.float32)
    b = rs.randn(cout).astype(np.float32)
    node = {"kernel": torch.from_numpy(Q._d2s_deconv_kernel(w)),
            "bias": torch.from_numpy(b)}
    got = Q._fdeconv(x, node, Q._Run(torch.float32, False))
    ref = F.conv_transpose2d(x.permute(0, 3, 1, 2), torch.from_numpy(w),
                             torch.from_numpy(b), stride=2)
    assert got.shape == (2, 18, 14, cout)
    torch.testing.assert_close(got, ref.permute(0, 2, 3, 1), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("size", [(32, 32), (18, 26)])
def test_s2d_stem_matches_the_strided_conv(size):
    """The ``stem_s2d`` form (space-to-depth, 4x4/s1 at pad ((2, 1), (2,
    1))) against the 7x7/s2 conv at pad 3 it came from, both convs in f64
    and rounded to f32 before the f32 bias, as the folded forward does: the
    same taps, so within one f32 ulp (atol 1e-6)."""
    rs = np.random.RandomState(sum(size))
    x = torch.from_numpy(rs.randn(2, *size, 3))
    w = rs.randn(64, 3, 7, 7) / 12
    b = rs.randn(64).astype(np.float32)
    node = {"kernel": torch.from_numpy(Q._s2d_stem_kernel(w)),
            "bias": torch.from_numpy(b)}
    got = Q._fconv(Q._space_to_depth(x), node, Q._Run(torch.float64, False),
                   stride=1, pad=((2, 1), (2, 1)))
    ref = F.conv2d(x.permute(0, 3, 1, 2), torch.from_numpy(w), stride=2,
                   padding=3).permute(0, 2, 3, 1).float() + torch.from_numpy(b)
    assert got.shape == (2, size[0] // 2, size[1] // 2, 64)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


# ------------------------------------------------------ folded trees -----

TREES = {f"{mode}_{flag}": {**MODES[mode], **FLAGS[flag]}
         for mode in MODES for flag in FLAGS}
TREES["int8_s2d_min_in_1"] = dict(skip=(), **INT8_STEM)


@pytest.mark.parametrize("variant", sorted(TREES))
def test_rewritten_trees_match_jax(variant, jax_variables, state_dict):
    """``prepare_quant_params`` with each rewrite and both, folded and int8,
    against the JAX package's tree carried by ``quant_vars_from_jax``,
    leaf for leaf: the same shapes and dtypes, int8 kernels equal, f32
    leaves within 1 ulp. The rewritten kernels have the port's layouts:
    the stem OIHW (64, 12, 4, 4), or OHWI (64, 4, 4, 12) when int8
    (``INT8_STEM``), each deconv the 1x1 OIHW (4*cout, cin, 1, 1)."""
    kw = TREES[variant]
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
    stem = got["/params/backbone/conv1/kernel"]
    if kw.get("stem_s2d"):
        assert stem.shape == ((64, 4, 4, 12) if "min_in_1" in variant
                              else (64, 12, 4, 4))
        assert (stem.dtype == torch.int8) == ("min_in_1" in variant)
    else:
        assert stem.shape == (64, 3, 7, 7)
    head = "/params/segmentation_head/binarize_deconv"
    want = ((256, 64, 1, 1), (4, 64, 1, 1)) if kw.get("deconv_d2s") else (
        (64, 64, 2, 2), (64, 1, 2, 2))
    assert (got[head + "1/kernel"].shape, got[head + "2/kernel"].shape) \
        == want
    n_int8 = sum(v.dtype == torch.int8 for v in got.values())
    if "min_in_1" not in variant:
        assert n_int8 == {"folded": 0, "int8": 17}[variant.split("_")[0]]


def test_rewrites_are_off_by_default(state_dict):
    """The defaults give the plain forms, as the JAX package's do."""
    default = dict(_leaves(Q.prepare_quant_params(state_dict, skip=())))
    off = dict(_leaves(Q.prepare_quant_params(
        state_dict, skip=(), stem_s2d=False, deconv_d2s=False)))
    assert sorted(default) == sorted(off)
    assert all(torch.equal(default[p], off[p]) for p in default)
    assert default["/params/backbone/conv1/kernel"].shape == (64, 3, 7, 7)


# --------------------------------------------------------- forwards ------

@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_rewritten_folded_forward_matches_jax(flag, jax_variables,
                                              state_dict):
    """The folded forward in f32 with each rewrite and both, both maps and
    prob-only, against the JAX folded forward with the same flags (atol
    5e-5), and within the same bound of the port's plain folded forward."""
    x = _images()
    kw = {**MODES["folded"], **FLAGS[flag]}
    qv = Q.prepare_quant_params(state_dict, **kw)
    jq = JQ.prepare_quant_params(jax_variables, **kw)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JQ.quant_dbnet_forward(jq, jnp.asarray(x)))
    got = _forward(qv, x)
    assert got.shape == ref.shape == (2, SIZE, SIZE, 2)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_array_equal(_forward(qv, x, prob_only=True)[..., 0],
                                  got[..., 0])
    plain = _forward(Q.prepare_quant_params(state_dict, **MODES["folded"]),
                     x)
    np.testing.assert_allclose(got, plain, atol=ATOL)


INT8_RUNS = {f"{flag}_{scales}": (FLAGS[flag], scales)
             for flag in FLAGS for scales in ("dynamic", "static")}
INT8_RUNS["s2d_min_in_1_dynamic"] = (INT8_STEM, "dynamic")
INT8_RUNS["s2d_min_in_1_static"] = (INT8_STEM, "static")


@pytest.mark.parametrize("run", sorted(INT8_RUNS))
def test_rewritten_int8_forward_matches_jax_exactly(run, jax_variables,
                                                    f64_float_convs):
    """The int8 forward (skip=()) with each rewrite and both, dynamic scales
    and static ones calibrated by the JAX package, against the JAX forward
    on the carried tree with the float convs in f64 on both sides: every
    int8 activation equal, the maps within 1e-6. Under ``INT8_STEM`` the
    space-to-depth stem is int8 too, the first of the int8 convs (its int8
    input the unpadded space-to-depth map, zero-padded after
    quantization), with the 64-channel convs."""
    flags, scales = INT8_RUNS[run]
    x = _images()
    jq = JQ.prepare_quant_params(jax_variables, skip=(), **flags)
    if scales == "static":
        jq = JQ.calibrate_activation_scales(jq, [x[:1]])
    ref, ref_q = _jax_int8_run(jq, x)
    got_q = []
    got = _forward(quant_vars_from_jax(jq), x, compute_dtype=f64_float_convs,
                   int8_inputs=got_q)
    assert len(got_q) == len(ref_q)
    if "min_in_1" in run:
        assert len(got_q) > 17
        assert got_q[0].shape == (2, SIZE // 2, SIZE // 2, 12)
    else:
        assert len(got_q) == 17
    for a, b in zip(got_q, ref_q):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_rewritten_int8_forward_equals_the_plain_one(flag, state_dict,
                                                     f64_float_convs):
    """The rewrites are weight-exact: with the float convs in f64, the
    int8 forward (skip=(), static scales each tree calibrates for itself)
    with each rewrite and both gives the plain form's scales, every int8
    activation of it and its maps within 1e-6."""
    x = _images()
    runs = []
    for flags in ({}, FLAGS[flag]):
        qv = Q.calibrate_activation_scales(
            Q.prepare_quant_params(state_dict, skip=(), **flags), [x[:1]],
            compute_dtype=f64_float_convs)
        inputs = []
        runs.append((_forward(qv, x, compute_dtype=f64_float_convs,
                              int8_inputs=inputs), inputs,
                     [n["act_scale"].item()
                      for n in Q._forward_conv_order(qv["params"])]))
    (ref, ref_q, ref_s), (got, got_q, got_s) = runs
    assert got_s == ref_s
    assert len(got_q) == len(ref_q) == 17
    assert all(torch.equal(a, b) for a, b in zip(got_q, ref_q))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_rewritten_calibration_matches_jax(jax_variables, state_dict,
                                           f64_float_convs):
    """Static scales calibrated by the port on its own tree with both
    rewrites and the int8 stem (``INT8_STEM``) equal the JAX package's, on
    every int8 conv in forward order."""
    x = _images()
    kw = dict(skip=(), deconv_d2s=True, **INT8_STEM)
    jq = JQ.calibrate_activation_scales(
        JQ.prepare_quant_params(jax_variables, **kw), [x[:1], x[1:]])
    qv = Q.calibrate_activation_scales(
        Q.prepare_quant_params(state_dict, **kw), [x[:1], x[1:]],
        compute_dtype=f64_float_convs)
    ref = np.asarray([n["act_scale"]
                      for n in JQ._forward_conv_order(jq["params"])],
                     np.float32)
    got = np.asarray([n["act_scale"].item()
                      for n in Q._forward_conv_order(qv["params"])],
                     np.float32)
    assert len(got) == len(ref) > 17
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


@pytest.mark.parametrize("prob_only", [False, True])
def test_make_folded_forward_stem_s2d_matches_jax(prob_only, jax_variables,
                                                  state_dict):
    """``cli.common.make_folded_forward(stem_s2d=True)`` against the JAX
    package's, folded, in f32 (atol 5e-5); its tree holds the
    space-to-depth stem."""
    x = _images()
    fwd = make_folded_forward(state_dict, stem_s2d=True,
                              prob_only=prob_only, device="cpu")
    assert fwd.qvars["params"]["backbone"]["conv1"]["kernel"].shape \
        == (64, 12, 4, 4)
    jfwd = jax_common.make_folded_forward(jax_variables, stem_s2d=True,
                                          prob_only=prob_only)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jfwd(None, jnp.asarray(x)))
    got = fwd(x).numpy()
    assert got.shape == ref.shape == (2, SIZE, SIZE, 1 if prob_only else 2)
    np.testing.assert_allclose(got, ref, atol=ATOL)


# ---------------------------------------------------- public helpers -----

def test_cal_text_score_matches_jax():
    """``metrics.cal_text_score`` against the JAX package's on the same
    seeded maps, two updates of one running score each: equal scores and
    confusion matrices."""
    rs = np.random.RandomState(9)
    port, ref = RunningScore(2), jax_pixel.RunningScore(2)
    for _ in range(2):
        texts = rs.rand(3, 16, 20).astype(np.float32)
        gt = (rs.rand(3, 16, 20) > 0.6).astype(np.float32)
        masks = (rs.rand(3, 16, 20) > 0.1).astype(np.float32)
        got = cal_text_score(torch.from_numpy(texts), gt, masks, port, 0.4)
        want = jax_pixel.cal_text_score(texts, gt, masks, ref, 0.4)
        assert got == want
    np.testing.assert_array_equal(port.confusion_matrix,
                                  ref.confusion_matrix)
    assert port.confusion_matrix.sum() == 2 * 3 * 16 * 20


@pytest.mark.parametrize("shape,multiple", [
    ((37, 50, 3), 32), ((2, 64, 70, 3), 32), ((64, 96, 3), 32),
    ((1, 9, 9, 1), 4)])
def test_pad_to_multiple_matches_jax(shape, multiple):
    img = np.random.RandomState(len(shape)).rand(*shape).astype(np.float32)
    got, got_hw = port_utils.pad_to_multiple(img, multiple)
    ref, ref_hw = jax_utils.pad_to_multiple(img, multiple)
    assert got_hw == ref_hw == shape[-3:-1]
    assert got.shape == ref.shape
    assert got.shape[-3] % multiple == got.shape[-2] % multiple == 0
    np.testing.assert_array_equal(got, ref)


def test_timer_matches_jax(capsys, monkeypatch):
    """``utils.timer`` returns the call's result, keeps the function's name
    and prints the JAX package's line; the clock is fixed so that both
    print the same seconds."""
    def scaled(a, b=2):
        return a * b

    for module in (port_utils, jax_utils):
        ticks = iter([10.0, 10.25])
        monkeypatch.setattr(module.time, "time", lambda: next(ticks))
        wrapped = module.timer(scaled)
        assert wrapped.__name__ == "scaled"
        assert wrapped(3, b=4) == 12
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line == ">>> Function scaled: 0.25's"
