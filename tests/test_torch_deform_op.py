"""D1, the deformable conv's sampling (``ops/deform``), against the JAX
package on the CPU, where its wrappers run their plain versions:

- ``deform_im2col_plain``'s columns against JAX's ``_bilinear_sample``,
  tap by tap, at atol 1e-6 (the same f32 operations);
- ``deform_col2im_plain``'s ``dx`` and ``doffsets`` (the backward written
  out) against ``jax.vjp`` of the 9 taps' sampling, at atol 5e-5, the
  one-sided gradient at integer coordinates included;
- ``deform_conv`` (the custom ops and the per-tap products) forward and
  its three gradients against ``jax.grad`` of the JAX ``DeformConv`` with
  the offsets fed in, at the repo's atol 5e-5, and in bf16 against flax's
  bf16 output.

Offsets are either zero (every tap on an integer coordinate, as at init)
or random of several pixels, so that many taps and corners leave the 9×10
image; C is 4, 5 (the wrappers' one-channel-a-lane path) or 64; stride 1
and 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from db_text_minimal_tpu.models.deform import DeformConv as JaxDeformConv
from db_text_minimal_tpu.models.deform import _bilinear_sample
from db_text_minimal_tpu_torch.ops import deform as DF
from torch_families import ATOL, HIGHEST

torch.set_num_threads(1)

H, W = 9, 10


def _inputs(stride, c, offsets, seed=0):
    """(x (2, H, W, c), offsets (2, OH, OW, 18)) f32 numpy: zero offsets,
    or random ones of several pixels (normal, std 3)."""
    rs = np.random.RandomState(seed + 10 * stride + c)
    x = rs.randn(2, H, W, c).astype(np.float32)
    oh, ow = DF.out_size(H, stride), DF.out_size(W, stride)
    off = np.zeros((2, oh, ow, 18), np.float32)
    if offsets == "random":
        off = (rs.randn(2, oh, ow, 18) * 3).astype(np.float32)
        ys = (np.arange(oh) * stride)[None, :, None, None] + off[..., 0::2]
        assert (ys < -1).any() and (ys > H).any(), "no tap leaves the image"
    return x, off


def _jax_taps(x, offsets, stride):
    """The JAX module's 9 samples (9, N, OH, OW, C), its own coordinate
    arithmetic (deform.py:83-93)."""
    n, oh, ow, _ = offsets.shape
    off = offsets.reshape(n, oh, ow, 9, 2)
    base_y = (jnp.arange(oh, dtype=jnp.float32) * stride)[None, :, None]
    base_x = (jnp.arange(ow, dtype=jnp.float32) * stride)[None, None, :]
    taps = []
    for ky in range(3):
        for kx in range(3):
            tap = ky * 3 + kx
            sy = base_y + (ky - 1) + off[..., tap, 0]
            sx = base_x + (kx - 1) + off[..., tap, 1]
            taps.append(_bilinear_sample(x, sy, sx))
    return jnp.stack(taps)


CASES = [(s, c, o) for s in (1, 2) for c, o in ((4, "random"), (5, "random"),
                                                 (64, "random"), (4, "zero"),
                                                 (64, "zero"))]


@pytest.mark.parametrize("stride,c,offsets", CASES)
def test_im2col_plain_matches_jax_sampling(stride, c, offsets):
    x, off = _inputs(stride, c, offsets)
    ref = np.asarray(jax.jit(_jax_taps, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(off), stride))
    got = DF.deform_im2col(torch.from_numpy(x), torch.from_numpy(off),
                           stride, torch.float32)
    assert got.shape == (9, ref[0].size // c, c)
    np.testing.assert_allclose(got.numpy(), ref.reshape(9, -1, c), rtol=0,
                               atol=1e-6)
    # bf16 columns are the f32 samples rounded
    got16 = DF.deform_im2col(torch.from_numpy(x), torch.from_numpy(off),
                             stride, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, got.to(torch.bfloat16))
    assert DF.LAUNCHES == {"deform_im2col": 0, "deform_col2im": 0}


@pytest.mark.parametrize("stride,c,offsets", CASES)
def test_col2im_plain_matches_jax_vjp(stride, c, offsets):
    x, off = _inputs(stride, c, offsets)
    g = np.random.RandomState(3).randn(9, 2 * off.shape[1] * off.shape[2],
                                       c).astype(np.float32)
    _, vjp = jax.vjp(lambda a, o: _jax_taps(a, o, stride), jnp.asarray(x),
                     jnp.asarray(off))
    ref_dx, ref_doff = vjp(jnp.asarray(g.reshape(9, *off.shape[:3], c)))
    dx, doff = DF.deform_col2im(torch.from_numpy(x), torch.from_numpy(off),
                                torch.from_numpy(g), stride)
    assert dx.dtype == torch.float32 and doff.shape == off.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(doff.numpy(), np.asarray(ref_doff), rtol=0,
                               atol=5e-5)
    assert np.abs(np.asarray(ref_doff)).max() > 0.1
    if offsets == "zero":
        # one-sided at an integer coordinate: the centre tap's dy at output
        # (0, 0) is the difference towards the next row
        by_hand = (x[0, 1, 0] - x[0, 0, 0]) @ g[4, 0]
        np.testing.assert_allclose(doff[0, 0, 0, 8].item(), by_hand,
                                   rtol=1e-5)


def test_col2im_plain_takes_bf16_gradients_and_inputs():
    """bf16 column gradients are read as their f32 values; a bf16 input's
    gradient is the f32 one rounded."""
    x, off = _inputs(2, 8, "random")
    g = torch.from_numpy(np.random.RandomState(4).randn(
        9, 2 * off.shape[1] * off.shape[2], 8).astype(np.float32))
    g16 = g.to(torch.bfloat16)
    xt, ot = torch.from_numpy(x), torch.from_numpy(off)
    dx, doff = DF.deform_col2im(xt, ot, g16, 2)
    dx32, doff32 = DF.deform_col2im(xt, ot, g16.float(), 2)
    assert torch.equal(dx, dx32) and torch.equal(doff, doff32)
    x16 = xt.to(torch.bfloat16)
    dx16, _ = DF.deform_col2im(x16, ot, g, 2)
    ref, _ = DF.deform_col2im(x16.float(), ot, g, 2)
    assert dx16.dtype == torch.bfloat16
    assert torch.equal(dx16, ref.to(torch.bfloat16))


def test_sampling_survives_non_finite_and_huge_offsets():
    """NaN, infinite and huge offsets read no pixel outside the image: a
    huge offset's samples are zero and its gradients finite; a NaN
    offset's sample is NaN, as in JAX."""
    x, off = _inputs(1, 4, "zero")
    off[0, 0, 0, :4] = [np.nan, np.inf, -np.inf, 1e30]
    off[0, 1, 1, :2] = [3e9, -3e9]
    xt, ot = torch.from_numpy(x), torch.from_numpy(off)
    cols = DF.deform_im2col(xt, ot, 1, torch.float32)
    ref = np.asarray(_jax_taps(jnp.asarray(x), jnp.asarray(off), 1))
    np.testing.assert_allclose(cols.numpy(), ref.reshape(9, -1, 4), rtol=0,
                               atol=1e-6)
    assert torch.isnan(cols[0, 0]).all()
    assert (cols[0, W] == 0).all()      # pixel (0, 1, 1), tap 0: 3e9 away
    dx, doff = DF.deform_col2im(xt, ot, torch.ones_like(cols), 1)
    assert doff[0, 1, 1, :2].isfinite().all()


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, off = _inputs(1, 4, "zero")
    xt, ot = torch.from_numpy(x), torch.from_numpy(off)
    with pytest.raises(TypeError, match="offsets"):
        DF.deform_im2col(xt, ot[:, :-1], 1, torch.float32)
    with pytest.raises(TypeError, match="offsets"):
        DF.deform_im2col(xt, ot, 2, torch.float32)
    with pytest.raises(TypeError, match="x must"):
        DF.deform_im2col(xt.double(), ot, 1, torch.float32)
    with pytest.raises(TypeError, match="columns"):
        DF.deform_im2col(xt, ot, 1, torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        DF.deform_im2col(xt.permute(0, 2, 1, 3).contiguous().permute(
            0, 2, 1, 3), ot, 1, torch.float32)
    with pytest.raises(TypeError, match="gcols"):
        DF.deform_col2im(xt, ot, torch.zeros(9, 5, 4), 1)
    with pytest.raises(ValueError, match="CPU"):
        DF.deform_im2col(xt.to("meta"), ot, 1, torch.float32)


def _jax_conv(f, stride, dtype=jnp.float32):
    """The JAX ``DeformConv`` and a function of (x, offsets, kernel) that
    applies it with its offset branch's output replaced by ``offsets``."""
    jm = JaxDeformConv(f, stride=stride, dtype=dtype)

    def apply(x, offsets, kernel):
        c = x.shape[-1]
        params = {"offset_conv": {"kernel": jnp.zeros((3, 3, c, 18)),
                                  "bias": jnp.zeros((18,))},
                  "kernel": kernel}

        def intercept(next_fun, args, kwargs, context):
            if context.module.name == "offset_conv":
                return offsets
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(intercept):
            return jm.apply({"params": params}, x)

    return apply


@pytest.mark.parametrize("stride,c,offsets", [(1, 4, "random"),
                                              (2, 64, "random"),
                                              (1, 5, "zero"),
                                              (2, 4, "zero")])
def test_deform_conv_function_matches_jax_grad(stride, c, offsets):
    """The conv's output and its gradients with respect to the input,
    the offsets and the kernel against ``jax.grad`` of sum(out · G)."""
    f = 6
    x, off = _inputs(stride, c, offsets)
    rs = np.random.RandomState(5)
    kernel = (rs.randn(3, 3, c, f) * 0.3).astype(np.float32)
    g = rs.randn(2, off.shape[1], off.shape[2], f).astype(np.float32)
    conv = _jax_conv(f, stride)
    with jax.default_matmul_precision(HIGHEST):
        out = np.asarray(jax.jit(conv)(x, off, kernel))
        ref = jax.jit(jax.grad(lambda *a: jnp.sum(conv(*a) * g),
                               argnums=(0, 1, 2)))(x, off, kernel)
    tx = torch.from_numpy(x).requires_grad_()
    to = torch.from_numpy(off).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(
        kernel.transpose(3, 2, 0, 1))).requires_grad_()
    y = DF.deform_conv(tx, to, tw, stride, torch.float32)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), out, rtol=0, atol=ATOL)
    for name, got, want in (
            ("dx", tx.grad, ref[0]), ("doffsets", to.grad, ref[1]),
            ("dkernel", tw.grad.permute(2, 3, 1, 0), ref[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=name)


def test_deform_conv_function_bf16_matches_flax():
    """In bf16 the per-tap products and their sum run in bf16 and the
    sampling in f32, as in flax: the output within a mean relative 1e-4 of
    flax's bf16 output, where the f32 one lies over 10 × farther; the
    kernel's gradient comes back f32."""
    x, off = _inputs(1, 64, "random")
    kernel = (np.random.RandomState(6).randn(3, 3, 64, 32) * 0.05).astype(
        np.float32)
    ref16 = np.asarray(_jax_conv(32, 1, jnp.bfloat16)(x, off, kernel),
                       np.float32)
    ref32 = np.asarray(_jax_conv(32, 1)(x, off, kernel))
    tw = torch.from_numpy(np.ascontiguousarray(
        kernel.transpose(3, 2, 0, 1))).requires_grad_()
    out = DF.deform_conv(torch.from_numpy(x), torch.from_numpy(off), tw, 1,
                         torch.bfloat16)
    assert out.dtype == torch.bfloat16
    scale = np.abs(ref16).mean()
    got = np.abs(out.detach().float().numpy() - ref16).mean() / scale
    gap = np.abs(ref32 - ref16).mean() / scale
    assert got <= 1e-4 and got * 10 <= gap, (got, gap)
    out.float().sum().backward()
    assert tw.grad.dtype == torch.float32 and tw.grad.abs().max() > 0


def test_col2im_plain_takes_the_column_gradient_by_its_strides():
    """The (9, P, C) view of a (P, 9, C) tensor gives what its contiguous
    copy gives, bit for bit."""
    x, off = _inputs(2, 8, "random")
    p = off.shape[0] * off.shape[1] * off.shape[2]
    g = torch.from_numpy(np.random.RandomState(7).randn(p, 9, 8).astype(
        np.float32)).transpose(0, 1)
    xt, ot = torch.from_numpy(x), torch.from_numpy(off)
    assert not g.is_contiguous()
    got = DF.deform_col2im(xt, ot, g, 2)
    want = DF.deform_col2im(xt, ot, g.contiguous(), 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_conv_hands_col2im_one_product_not_a_stack(dtype,
                                                          monkeypatch):
    """The column gradient reaches ``deform_col2im`` as the (9, P, C) view
    of one (P, 9, C) product g @ [W_0ᵀ | … | W_8ᵀ], no stacked copy, and
    the conv's three gradients equal those of the per-tap products taken
    back by autograd (the 9 tap gradients stacked), within a bf16 ulp."""
    c, f, stride = 8, 6, 1
    x, off = _inputs(stride, c, "random")
    w = torch.from_numpy((np.random.RandomState(8).randn(f, c, 3, 3) * 0.3)
                         .astype(np.float32))
    g = torch.from_numpy(np.random.RandomState(9).randn(
        2, off.shape[1], off.shape[2], f).astype(np.float32))
    seen = []
    col2im = DF.deform_col2im

    def spy(xx, oo, gcols, s):
        seen.append((gcols.shape, gcols.stride(), gcols.is_contiguous()))
        return col2im(xx, oo, gcols, s)

    monkeypatch.setattr(DF, "deform_col2im", spy)

    def grads(conv):
        tx = torch.from_numpy(x).requires_grad_()
        to = torch.from_numpy(off).requires_grad_()
        tw = w.clone().requires_grad_()
        (conv(tx, to, tw).float() * g).sum().backward()
        return tx.grad, to.grad, tw.grad

    def stacked(tx, to, tw):
        cols = DF.deform_im2col(tx, to, stride, dtype).unbind(0)
        taps = DF._taps(tw, dtype).unbind(0)
        out = cols[0] @ taps[0]
        for t in range(1, 9):
            out = out + cols[t] @ taps[t]
        return out.reshape(*off.shape[:3], -1)

    got = grads(lambda *a: DF.deform_conv(*a, stride, dtype))
    p = off.shape[0] * off.shape[1] * off.shape[2]
    assert seen == [((9, p, c), (c, 9 * c, 1), False)]
    want = grads(stacked)
    assert seen[1][2]    # the stack is contiguous
    for a, b in zip(got, want):
        tol = 0.0 if dtype == torch.float32 else 2.0 ** -7
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-6 * scale + tol * scale
