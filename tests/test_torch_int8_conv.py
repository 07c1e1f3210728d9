"""The int8 convolution op ``dbtext::int8_conv`` (``ops/int8.int8_conv``)
on the CPU: its plain version against the route it replaces (im2col,
``torch._int_mm``, P1), the kernel's A-tile addressing written out in plain
torch against im2col's columns, the wrapper's padded layouts, and the op
against the JAX package's ``conv_general_dilated(int8, int8,
preferred_element_type=int32)`` followed by the probe's TPU kernel
``_epi_kernel`` in Pallas' interpret mode. The kernel itself runs on the
card (``tests/test_torch_cuda.py -k int8_conv``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from db_text_minimal_tpu_torch.ops import int8 as I
from test_torch_quant import _probe_kernel

torch.set_num_threads(1)

# (k, stride, pad) of the forward's int8 convs: 3x3 at strides 1 and 2,
# 1x1 downsamples at stride 2, and 1x1 at stride 1
GEOMETRY = [(3, 1, 1), (3, 2, 1), (1, 2, 0), (1, 1, 0)]
# full widths, and the odd widths of a pruned model (Cin 37: K = 9 * 37;
# Cout 130: the rows padded to 136 by pad_cols)
WIDTHS = {"full": (64, 128), "odd": (37, 130)}


def _inputs(n, h, w, cin, cout, k, seed=0):
    """int8 NHWC input, the (kh, kw, cin) column weights padded as the
    quantizer pads them, and per-row scales and biases (zero on padded
    rows)."""
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randint(-127, 128, (n, h, w, cin)).astype(
        np.int8))
    w_cols = rs.randint(-127, 128, (cout, k * k * cin)).astype(np.int8)
    padded = I.pad_cols(w_cols)
    w_cols = torch.from_numpy(w_cols if padded is None else padded)
    rows = w_cols.shape[0]
    scale = np.zeros(rows, np.float32)
    bias = np.zeros(rows, np.float32)
    scale[:cout] = rs.rand(cout) * 2e-5
    bias[:cout] = rs.randn(cout) * 0.5
    return q, w_cols, torch.from_numpy(scale), torch.from_numpy(bias)


@pytest.mark.parametrize("widths", sorted(WIDTHS))
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("form", ["f32", "int8"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("k,stride,pad", GEOMETRY)
def test_op_matches_the_route_it_replaces(k, stride, pad, batch, form, relu,
                                          widths):
    """The op on CPU tensors is bit-equal to im2col + ``torch._int_mm``
    followed by P1 (the custom op ``dbtext::int8_epilogue``), in both
    forms, at full and at pruned odd widths, and counts no launch."""
    cin, cout = WIDTHS[widths]
    q, w_cols, scale, bias = _inputs(batch, 9, 7, cin, cout, k,
                                     seed=k + stride + batch)
    out_scale = torch.tensor(0.01, dtype=torch.float32) if form == "int8" \
        else None
    I.reset_launches()
    got = I.int8_conv(q, w_cols, k, stride, pad, scale, bias, relu,
                      out_scale)
    acc = I.int8_conv2d(q, w_cols, k, stride, pad)
    ref = I.int8_epilogue(acc.view(-1, w_cols.shape[0]), scale, bias, relu,
                          out_scale).view(acc.shape)
    assert got.dtype == (torch.int8 if form == "int8" else torch.float32)
    assert got.shape == acc.shape
    assert torch.equal(got, ref)
    assert not got[..., cout:].any()
    assert set(I.LAUNCHES.values()) == {0}
    if form == "int8":   # clipped at 127 somewhere, and at -127 without relu
        assert got.max() == 127 and (relu or got.min() == -127)


# ------------------------------------------- the kernel's A-tile gather ---

def _advance(state, by, k, cs16):
    """``advance`` of ``csrc/int8_conv.cu``: move a chunk's (kh, kw, c16)
    on by ``by`` 16-byte chunks; kh == k once past K."""
    kh, kw, c16 = state
    c16 += by
    while c16 >= cs16:
        c16 -= cs16
        kw += 1
        if kw == k:
            kw, kh = 0, kh + 1
    return kh, kw, c16


CHUNKS = 4   # 16-byte chunks of K a stage of the kernel


def _tile_offset(row, chunk):
    """``tile_offset``: rows of 4 16-byte chunks, each row's chunk index
    XORed with its row bits 1-2 (wgmma's 64-byte swizzle)."""
    return row * CHUNKS * 16 + ((chunk ^ ((row & 7) >> 1)) << 4)


def _kernel_tiles(q, k, stride, pad, cs, bm=128, threads=256):
    """The A tiles the kernel gathers, stage by stage, written out in plain
    torch from its addressing: thread ``tid`` copies chunk ``tid % 4`` of
    rows ``tid // 4 + (threads // 4) i`` of the block's output pixels; a
    chunk reads 16 bytes of pixel (oh * stride - pad + kh, ow * stride -
    pad + kw) at channel 16 * c16, or zero-fills them (row past M, chunk
    past K, tap outside the image). Returns, per block, the stages' shared
    memory images (bytes, uint8)."""
    n, h, w, _ = q.shape
    qp = torch.zeros((n, h, w, cs), dtype=torch.int8)
    qp[..., :q.shape[3]] = q
    flat = qp.reshape(-1).view(torch.uint8)
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    m, cs16 = n * ho * wo, cs // 16
    kchunks = k * k * cs16
    ktiles = -(-kchunks // CHUNKS)
    blocks = []
    for m0 in range(0, m, bm):
        stages = [torch.zeros(bm * CHUNKS * 16, dtype=torch.uint8)
                  for _ in range(ktiles)]
        for tid in range(threads):
            chunk = tid % CHUNKS
            state = _advance((0, 0, 0), chunk, k, cs16)
            for kt in range(ktiles):
                kh, kw, c16 = state
                for i in range(bm * CHUNKS // threads):
                    row = tid // CHUNKS + threads // CHUNKS * i
                    mrow = m0 + row
                    ow, oh = mrow % wo, mrow // wo % ho
                    img = mrow // (wo * ho)
                    ih, iw = oh * stride - pad + kh, ow * stride - pad + kw
                    at = _tile_offset(row, chunk)
                    if mrow < m and kh < k and 0 <= ih < h and 0 <= iw < w:
                        src = ((img * h + ih) * w + iw) * cs + c16 * 16
                        stages[kt][at:at + 16] = flat[src:src + 16]
                state = _advance(state, CHUNKS, k, cs16)
        blocks.append(stages)
    return blocks, m, kchunks


def _wgmma_rows(stage, rows, kk):
    """What a wgmma k32 step reads from a stage's A tile through the
    swizzled K-major descriptor (start + 32 kk, stride byte offset 512,
    the 64-byte swizzle), for the block's ``rows`` rows: row r's 16-byte
    halves at the unswizzled address (r // 8) * 512 + (r % 8) * 64 + 32 kk
    + 16 half, whose bits [4, 6) the hardware XORs with bits [7, 9)."""
    out = torch.zeros((rows, 32), dtype=torch.uint8)
    for r in range(rows):
        for half in range(2):
            at = (r >> 3) * 512 + (r & 7) * 64 + 32 * kk + 16 * half
            at ^= ((at >> 7) & 3) << 4
            out[r, 16 * half:16 * half + 16] = stage[at:at + 16]
    return out


@pytest.mark.parametrize("cin", [128, 64, 37, 8])
@pytest.mark.parametrize("k,stride,pad", GEOMETRY)
def test_kernel_a_tiles_are_im2col_columns(k, stride, pad, cin):
    """The kernel's A-tile addressing, swizzle and zero-fill, by tap and
    16-byte channel slice (each tap's channels padded to Cs = 16 ceil(Cin /
    16)), read back as the swizzled wgmma descriptors read it, give im2col's columns bit
    for bit, with zeros in the padded channels and past M and K; over two
    or more row tiles (the last ragged), at Cs above, equal to and below a
    stage's chunks."""
    rs = np.random.RandomState(cin + k)
    q = torch.from_numpy(rs.randint(-127, 128, (2, 17, 17, cin)).astype(
        np.int8))
    cs = -(-cin // 16) * 16
    blocks, m, kchunks = _kernel_tiles(q, k, stride, pad, cs)
    cols = I.im2col(q, k, stride, pad).view(torch.uint8)
    got = torch.zeros((len(blocks) * 128, len(blocks[0]) * CHUNKS * 16),
                      dtype=torch.uint8)
    for b, stages in enumerate(blocks):
        for kt, stage in enumerate(stages):
            for kk in range(CHUNKS // 2):
                at = kt * CHUNKS * 16 + 32 * kk
                got[128 * b:128 * b + 128, at:at + 32] = _wgmma_rows(
                    stage, 128, kk)
    assert len(blocks) >= 2 and m % 128
    kbytes = kchunks * 16
    taps = got[:m, :kbytes].view(m, k * k, cs)
    assert torch.equal(taps[..., :cin].reshape(m, -1), cols)
    assert not taps[..., cin:].any()
    assert not got[m:].any() and not got[:, kbytes:].any()


# -------------------------------------------- the wrapper's layouts ------

@pytest.mark.parametrize("cin,cout", [(64, 128), (37, 130), (8, 24),
                                      (256, 512)])
def test_padded_layouts_give_the_same_convolution(cin, cout):
    """The CUDA wrapper's input and weights as the kernel reads them: the
    input used as it is where its pixels lie 16-byte multiples apart
    (else a copy with the channels zero-padded to Cs), the weights padded
    per tap to Cs. The plain convolution of those layouts equals the
    unpadded one."""
    q, w_cols, _, _ = _inputs(2, 8, 6, cin, cout, 3, seed=cin)
    cs = -(-cin // 16) * 16
    qk, ldq = I._padded_input(q, cs)
    assert (qk is q) == (cin % 16 == 0) and ldq == cs
    assert torch.equal(qk[..., :cin], q) and not qk[..., cin:].any()
    wk = I._tap_weights(w_cols, 3, cin, cs)
    assert (wk is w_cols) == (cin % 16 == 0 and cout % 8 == 0)
    assert wk.shape == (w_cols.shape[0], 9 * cs)
    assert torch.equal(I.int8_conv2d(qk, wk, 3, 1, 1),
                       I.int8_conv2d(q, w_cols, 3, 1, 1))
    # an earlier int8_conv's output at padded rows, sliced to its channels:
    # read in place when its row stride is a multiple of 16
    wide = torch.zeros((2, 8, 6, cs + 16), dtype=torch.int8)
    wide[..., :cin] = q
    view, ld = I._padded_input(wide[..., :cin], cs)
    assert view.data_ptr() == wide.data_ptr() and ld == cs + 16
    moved, ld = I._padded_input(wide[:, 1:, :, :cin], cs)
    assert ld == cs and torch.equal(moved[..., :cin], q[:, 1:])


# --------------------------------------------------- against the JAX side --

@pytest.mark.parametrize("k,stride,pad", GEOMETRY[:3])
def test_op_matches_jax_conv_and_the_probe_kernel(k, stride, pad):
    """The op's int8 form against the JAX int8 conv
    (``conv_general_dilated(int8, int8, preferred_element_type=int32)``, as
    ``models/quant_infer.py:238`` calls it) followed by the TPU kernel
    ``_epi_kernel`` in interpret mode on the probe's grid of (1, 4, W, C)
    blocks, at the probe's activation scale: bit for bit."""
    kernel, act_scale = _probe_kernel()
    rs = np.random.RandomState(10 * k + stride)
    q = rs.randint(-127, 128, (2, 10, 9, 64)).astype(np.int8)
    w = rs.randint(-127, 128, (k, k, 64, 128)).astype(np.int8)   # HWIO
    eff = (rs.rand(128) * 4e-5).astype(np.float32)
    bias = (rs.randn(128) * 0.5).astype(np.float32)
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(q), jnp.asarray(w), (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    n, h, wd, c = acc.shape
    spec = pl.BlockSpec((1, 4, wd, c), lambda i, j: (i, j, 0, 0))
    vspec = pl.BlockSpec((c,), lambda i, j: (0,))
    ref = np.asarray(pl.pallas_call(
        kernel, grid=(n, pl.cdiv(h, 4)), in_specs=[spec, vspec, vspec],
        out_specs=spec, out_shape=jax.ShapeDtypeStruct(acc.shape, jnp.int8),
        interpret=True)(acc, jnp.asarray(eff), jnp.asarray(bias)))
    w_cols = torch.from_numpy(np.ascontiguousarray(
        w.transpose(3, 0, 1, 2))).reshape(128, -1)
    got = I.int8_conv(torch.from_numpy(q), w_cols, k, stride, pad,
                      torch.from_numpy(eff), torch.from_numpy(bias), True,
                      torch.tensor(act_scale, dtype=torch.float32))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < (ref == 127).mean() < 0.5 and (ref == 0).any()


def test_op_refuses_what_it_does_not_take():
    q, w_cols, scale, bias = _inputs(1, 5, 5, 16, 16, 3)
    with pytest.raises(TypeError, match="int8 NHWC"):
        I.int8_conv(q.float(), w_cols, 3, 1, 1, scale, bias, True)
    with pytest.raises(TypeError, match="w_cols"):
        I.int8_conv(q, w_cols.int(), 3, 1, 1, scale, bias, True)
    with pytest.raises(ValueError, match="fewer than"):
        I.int8_conv(q, w_cols[:, :100], 3, 1, 1, scale, bias, True)
    with pytest.raises(ValueError, match="does not fit"):
        I.int8_conv(q[:, :2, :2], w_cols, 3, 1, 0, scale, bias, True)
    with pytest.raises(TypeError, match="scale"):
        I.int8_conv(q, w_cols, 3, 1, 1, scale[:8], bias, True)
    with pytest.raises(TypeError, match="bias"):
        I.int8_conv(q, w_cols, 3, 1, 1, scale, bias.double(), True)
    with pytest.raises(TypeError, match="out_scale"):
        I.int8_conv(q, w_cols, 3, 1, 1, scale, bias, True, scale)
