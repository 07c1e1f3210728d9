"""The DB head's fused train-mode tail and K10, OHEM's top-k select, on the
CPU against the JAX package and against the composition they replace.

- ``DBHead`` in train mode (through ``ops.db_step.db_tail``, its plain
  halves here) against JAX's ``DBHead(train=True)`` with carried weights:
  the output, the input gradient and every parameter gradient (fp32, atol
  5e-5); ``db_tail`` against the composition it replaces (the f32 casts and
  sigmoids, K2, the concatenation) bit for bit, forward and backward, in
  f32 and bf16.
- ``ops.ohem``'s numpy steps of the K10 kernels (order keys, the rank kk,
  the radix select, the replay of the 34 rounds) against the plain
  bisection, ``lo`` bit for bit: ties at the kk-th value, k = 0, k past the
  count, an all-zero map, a one-valued map, and a kk past 2**24 from a
  synthetic count. ``topk_sum`` and ``ohem_balance_bce`` against JAX's.
- On CPU tensors neither reaches a kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu import losses as JL
from db_text_minimal_tpu.models.head import DBHead as JaxDBHead
from db_text_minimal_tpu_torch import losses as L
from db_text_minimal_tpu_torch.models.head import DBHead
from db_text_minimal_tpu_torch.models.layers import Sigmoid32
from db_text_minimal_tpu_torch.ops import db_step as D
from db_text_minimal_tpu_torch.ops import db_step_triton
from db_text_minimal_tpu_torch.ops import ohem as OH
from db_text_minimal_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

ATOL = 5e-5        # the repo's model parity tolerance
C, WIDTH, HW, N = 32, 8, 8, 2


# ------------------------------------------------------------ the tail ----

@pytest.fixture(scope="module")
def head_case():
    """JAX's DBHead at 32 channels, width 8, on (2, 8, 8, 32), its 1-D
    leaves nudged off their init values, and a seeded cotangent of its
    (2, 32, 32, 3) train-mode output, scaled so that the gradients are of
    order 1 (conv1's sum 6144 outputs' terms; two f32 summation orders
    leave ~1e-5 of their size)."""
    rs = np.random.RandomState(0)
    x = rs.randn(N, HW, HW, C).astype(np.float32)
    head = JaxDBHead(width=WIDTH)
    v = jax.device_get(head.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 train=False))

    def nudge(a):
        a = np.asarray(a)
        return a if a.ndim != 1 else (
            a + np.abs(rs.randn(*a.shape)) * 0.05).astype(a.dtype)

    params = jax.tree.map(nudge, v["params"])
    stats = jax.tree.map(nudge, v["batch_stats"])
    cot = (rs.randn(N, 4 * HW, 4 * HW, 3) * 0.1).astype(np.float32)
    return head, x, params, stats, cot


def _torch_keys(params, stats=None) -> dict:
    prefix = "segmentation_head."
    sd = state_dict_from_jax({"segmentation_head": params},
                             {"segmentation_head": stats or {}})
    return {k[len(prefix):]: v for k, v in sd.items()}


def test_train_mode_head_matches_jax(head_case):
    head, x, params, stats, cot = head_case

    def loss(params, x):
        out, _ = head.apply({"params": params, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), out

    (_, ref), (g_params, g_x) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    model = DBHead(C, WIDTH)
    model.load_state_dict(_torch_keys(params, stats))
    model.train()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = model(tx).permute(0, 2, 3, 1)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(g_x), rtol=0, atol=ATOL)
    want = {k: v for k, v in _torch_keys(g_params).items()
            if not k.endswith("num_batches_tracked")}
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(want)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[key].numpy(), rtol=0,
                                   atol=ATOL, err_msg=key)


def _old_tail(zb, zt, k=50.0):
    """The composition the tail replaced, as the head ran it."""
    shrink, threshold = Sigmoid32()(zb), Sigmoid32()(zt)
    return torch.cat([shrink, threshold, D.db_step(shrink, threshold, k)],
                     dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_is_the_old_composition_bit_for_bit(dtype):
    g = torch.Generator().manual_seed(1)
    # the deconv's output layout: (N, 1, H, W) over channels-last strides
    zb = (torch.randn(2, 17, 23, 1, generator=g) * 4).to(dtype).permute(
        0, 3, 1, 2)
    zt = (torch.randn(2, 17, 23, 1, generator=g) * 4).to(dtype).permute(
        0, 3, 1, 2)
    zb.view(-1)[:3] = torch.tensor([0.0, 60.0, -60.0]).to(dtype)
    cot = torch.randn(2, 17, 23, 3, generator=g).permute(0, 3, 1, 2)
    assert torch.equal(D.db_tail_plain(zb, zt), _old_tail(zb, zt))
    grads = []
    for fn in (D.db_tail, _old_tail):
        b, t = zb.clone().requires_grad_(), zt.clone().requires_grad_()
        out = fn(b, t)
        grads.append((out,) + torch.autograd.grad(out, (b, t), cot))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
        assert got.stride() == want.stride()
    # the written-out backward takes any layout of the gradient
    for layout in (cot, cot.contiguous()):
        got = D.db_tail_backward(layout, zb, zt)
        assert all(torch.equal(a, b) for a, b in zip(got, grads[1][1:]))


def test_train_mode_head_is_the_old_head_bit_for_bit(head_case):
    """Forward, input and parameter gradients and the BN statistics of the
    head through the tail equal those through the old composition."""
    _, x, params, stats, cot = head_case
    runs = []
    for fused in (True, False):
        model = DBHead(C, WIDTH)
        model.load_state_dict(_torch_keys(params, stats))
        model.train()
        tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        if fused:
            out = model(tx)
        else:
            out = _old_tail(model.binarize[:-1](tx), model.thresh[:-1](tx),
                            model.k)
        (out.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
        runs.append([out.detach(), tx.grad]
                    + [p.grad for p in model.parameters()]
                    + [b for b in model.buffers()])
    for got, want in zip(*runs):
        assert torch.equal(got, want)


def test_tail_checks_its_inputs():
    z = torch.zeros(2, 1, 4, 4)
    with pytest.raises(ValueError, match="N, 1, H, W"):
        D.db_tail_forward(torch.zeros(2, 2, 4, 4), torch.zeros(2, 2, 4, 4))
    with pytest.raises(TypeError, match="dtype"):
        D.db_tail_forward(z, z.double())
    with pytest.raises(TypeError, match="gradient"):
        D.db_tail_backward(torch.zeros(2, 2, 4, 4), z, z)


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def refuse(*args):
        raise AssertionError("a CPU tensor reached a kernel")

    monkeypatch.setattr(db_step_triton, "kernels", refuse)
    monkeypatch.setattr(OH, "load_library", refuse)
    D.reset_launches()
    OH.reset_launches()
    z = torch.randn(1, 1, 8, 8).requires_grad_()
    D.db_tail(z, z * 0.5).sum().backward()
    v = torch.rand(64).requires_grad_()
    OH.topk_sum(v, torch.tensor(5.0)).backward()
    assert not any(D.LAUNCHES.values()) and not any(OH.LAUNCHES.values())


# ----------------------------------------------------------------- K10 ----

def _lo_bits(values: np.ndarray, k: float) -> tuple[bytes, bytes]:
    """The bisection's lo and the kernels' steps' lo, as bytes."""
    lo = OH.bisection_lo(torch.from_numpy(values),
                         torch.tensor(k, dtype=torch.float32))
    return lo.numpy().tobytes(), np.float32(OH.select_lo(values,
                                                         k)).tobytes()


def _maps():
    rs = np.random.RandomState(3)
    ties = np.repeat(np.float32([3.0, 1.25, 0.5, 0.0]), [5, 400, 300, 295])
    rs.shuffle(ties)
    bce = np.where(rs.rand(4096) < 0.3, -np.log(np.float32(1e-7)),
                   rs.rand(4096)).astype(np.float32)
    return {
        # k in the middle of a run of 400 equal values
        "ties at kk": (ties, 200.0),
        "ties, fractional k": (ties, 200.5),
        "ties, k at a run's end": (ties, 405.0),
        "clamped BCE": (bce, 1500.0),
        "k 0": (ties, 0.0),
        "k negative": (ties, -3.0),
        "k the count": (ties, 1000.0),
        "k past the count": (ties, 1000.5),
        "k far past the count": (ties, 1e9),
        "k NaN": (ties, float("nan")),
        "all zero": (np.zeros(777, np.float32), 10.0),
        "one value": (np.full(513, 0.6931, np.float32), 100.0),
        "one entry": (np.float32([2.5]), 1.0),
        "tiny values": ((rs.rand(999) ** 6 * 1e-30).astype(np.float32),
                        333.0),
        "large values": ((rs.rand(999) * 1e6).astype(np.float32), 10.0),
        "random": (rs.rand(5000).astype(np.float32), 1234.0),
    }


@pytest.mark.parametrize("case", sorted(_maps()))
def test_select_replay_gives_the_bisection_lo(case):
    values, k = _maps()[case]
    got, want = _lo_bits(values, k)
    assert got == want


@pytest.mark.parametrize("case", ["ties at kk", "clamped BCE", "random",
                                  "large values", "tiny values"])
def test_radix_select_finds_the_kth_largest(case):
    values, _ = _maps()[case]
    keys = OH.order_keys(values)
    ordered = np.sort(values)[::-1]
    for kk in (1, 2, len(values) // 3, len(values) - 1, len(values)):
        assert OH.key_value(OH.radix_select(keys, kk)) == ordered[kk - 1]


def test_order_keys_keep_the_float_order():
    v = np.float32([-np.inf, -2.5, -1e-40, -0.0, 0.0, 1e-45, 1e-38, 0.5,
                    1.0, 3e38, np.inf])
    keys = OH.order_keys(v)
    assert np.all(keys[1:] >= keys[:-1])
    assert keys[3] == keys[4]            # -0 and +0 are one value
    assert [OH.key_value(int(key)) for key in keys[5:]] == list(v[5:])


def test_target_rank_is_the_least_count_that_reaches_k():
    """kk is the least integer c with float32(c) >= k, also where float32
    rounds the count (past 2**24)."""
    rs = np.random.RandomState(5)
    base = [0.0, 0.5, 1.0, 7.25, 2.0 ** 24 - 1, 2.0 ** 24]
    ks = base + [float(np.float32(2.0 ** 24 + d)) for d in range(1, 40)]
    ks += [float(np.float32(2.0 ** e * (1 + rs.rand())))
           for e in range(24, 30) for _ in range(5)]
    n = 2 ** 31 - 1
    for k in ks:
        kk = OH.target_rank(k, n)
        assert np.float32(kk) >= np.float32(k)
        assert kk == 0 or np.float32(kk - 1) < np.float32(k)
    assert OH.target_rank(10.0, 9) == 10
    assert OH.target_rank(float("nan"), 9) == 10


@pytest.mark.parametrize("k", [2.0 ** 24 + 4, 2.0 ** 24 + 2, 2.0 ** 24 + 8,
                               2.0 ** 25 + 8, 2.0 ** 24 + 16, 7.0])
def test_replay_past_2_24_from_a_synthetic_count(k):
    """A multiset of 2**24 + 3 values of 0.9 and a few of others (too many
    to hold): the bisection run on counts, compared in float32 as the
    plain version compares them, against the replay. At k = 2**24 + 4 the
    count 2**24 + 3 reaches k (float32 rounds it to 2**24 + 4), so the
    k-th largest is 0.9 and not the next value."""
    values = np.float32([0.9, 0.5, 0.25, 0.0])
    counts = np.array([2 ** 24 + 3, 10, 2 ** 25, 7], np.int64)
    n = int(counts.sum())
    k32 = np.float32(k)
    hi = np.maximum(values.max(), np.float32(1.0))
    lo = np.float32(-1.0) * hi
    for _ in range(OH.ITERS):
        mid = np.float32(0.5) * (lo + hi)
        keep = np.float32(counts[values > mid].sum()) >= k32
        lo, hi = (mid, hi) if keep else (lo, mid)
    kk = OH.target_rank(k32, n)
    order = np.argsort(values)[::-1]
    position = np.searchsorted(np.cumsum(counts[order]), kk)
    v = values[order][position] if 1 <= kk <= n else None
    got = OH.replay(values.max(), v, kk, n)
    assert np.float32(got).tobytes() == np.float32(lo).tobytes()


# k10_select's launch at small sizes: one block with everything staged;
# three blocks that stage 16 words each and stream the rest, from a start
# 4 bytes past a 16-byte boundary; more blocks than words
LAUNCH_SHAPES = {
    "one block, staged": dict(blocks=1, cap4=2048, head=0, threads=32),
    "three blocks, streamed, unaligned": dict(blocks=3, cap4=16, head=1,
                                              threads=8, run=3),
    "seven blocks, two words each": dict(blocks=7, cap4=2, head=3,
                                         threads=4, run=5),
}


def _hold_cooperative(values: np.ndarray, k: float, shape: dict) -> dict:
    """The launch written out against the bisection: lo bit for bit, the
    sum within 1e-5 of the size of its two terms, one bucket a pass."""
    got = OH.cooperative_select(values, k, **shape)
    v, kt = torch.from_numpy(values), torch.tensor(k, dtype=torch.float32)
    lo = OH.bisection_lo(v, kt)
    assert np.float32(got["lo"]).tobytes() == lo.numpy().tobytes()
    ref = float(OH.topk_sum_plain(v, kt))
    if np.isnan(ref):
        assert np.isnan(got["out"])
    else:
        assert abs(float(got["out"]) - ref) <= 1e-5 * max(
            OH.sum_scale(v, lo, kt), 1e-30)
    # every block picks the same bucket from the merged bins
    assert all(len(set(picks)) == 1 for picks in got["picks"])
    return got


@pytest.mark.parametrize("shape", sorted(LAUNCH_SHAPES))
@pytest.mark.parametrize("case", sorted(_maps()))
def test_cooperative_select_gives_the_bisection_lo(case, shape):
    values, k = _maps()[case]
    _hold_cooperative(values, k, LAUNCH_SHAPES[shape])


@pytest.mark.parametrize("k", [1.0, 3000.0, 17_000.5])
def test_cooperative_select_streams_what_shared_memory_misses(k):
    """A map of 20,000 loss-like values (runs of zeros and of clamped BCE
    among smooth values) over 4 blocks that stage 256 words each (4,096
    values): most of each slice is read from device memory in every
    sweep."""
    rs = np.random.RandomState(7)
    smooth = np.repeat(rs.rand(2500) * 2, 8)[:20_000]
    runs = np.repeat(rs.randint(0, 3, 625), 32)
    values = np.where(runs == 0, 0.0, np.where(
        runs == 1, -np.log(np.float32(1e-7)), smooth)).astype(np.float32)
    plan = OH.block_slices(values.size, 2, 4, 256, 16)
    assert [p["staged"].size for p in plan] == [1024] * 4
    assert sum(p["rest"].size for p in plan) == values.size - 4096
    _hold_cooperative(values, k, dict(blocks=4, cap4=256, head=2,
                                      threads=16))


@pytest.mark.parametrize("n,head,blocks,cap4", [
    (1, 0, 4, 8), (1, 3, 4, 8), (3, 1, 2, 1), (1000, 2, 132, 13976),
    (4099, 3, 5, 7), (6000, 0, 3, 500)])
def test_block_slices_take_each_value_once(n, head, blocks, cap4):
    """Every value once; of each chunk of staged values a thread takes the
    RUN consecutive ones from RUN * thread on (RUN odd: the 32 lanes'
    loads hit 32 banks); a list's threads take contiguous runs of an odd
    count."""
    plan = OH.block_slices(n, head, blocks, cap4, threads=32)
    idx = np.concatenate([np.r_[p["staged"], p["rest"]] for p in plan])
    assert np.array_equal(np.sort(idx), np.arange(n))
    assert OH.RUN % 2 == 1
    for p in plan:
        staged = p["staged"]
        assert staged.size <= 4 * cap4
        assert np.all(np.diff(staged) == 1)
        if staged.size:
            offset = (staged - staged[0]) % (OH.RUN * 32)
            assert np.array_equal(offset // OH.RUN, p["staged_owner"])
    for length in (1, 31, 32, 33, 1000):
        owner = OH.list_owner(length, 32)
        runs = np.bincount(owner)
        assert owner.size == length and np.all(np.diff(owner) >= 0)
        assert runs.size <= 32 and runs[0] % 2 == 1
        assert np.all(runs[:-1] == runs[0]) and runs[-1] <= runs[0]
    assert OH.list_owner(0, 32).size == 0


def test_runs_flush_once_where_the_bin_changes():
    """On a map of one value every thread adds one (bin, count) pair a
    pass; on a map of 8 runs of 512 equal values, one a chunk (its values
    of each chunk lie elsewhere) and one more at each run boundary it
    crosses; on a map of random values nearly every value is a pair of its
    own."""
    shape = dict(blocks=2, cap4=4096, threads=32)
    one = np.full(4096, 0.6931, np.float32)
    plan = OH.block_slices(one.size, 0, 2, 4096, 32)
    threads = sum(len(set(p["staged_owner"].tolist())) for p in plan)
    got = _hold_cooperative(one, 100.0, shape)
    listed = sum(len(set(OH.list_owner(size, 32).tolist()))
                 for size in got["lists"])
    assert got["atomics"] == [threads, listed, listed]
    runs = np.repeat(np.float32([3.0, 0.5, 9.0, 0.0, 1.5, 0.25, 6.0, 0.1]),
                     512)
    got = _hold_cooperative(runs, 700.0, shape)
    chunks = -(-runs.size // (OH.RUN * 32))
    assert got["atomics"][0] <= chunks * threads + 8
    noise = np.random.RandomState(1).rand(4096).astype(np.float32)
    got = _hold_cooperative(noise, 700.0, shape)
    assert got["atomics"][0] > 0.5 * noise.size


@pytest.mark.parametrize("case,source", [
    ("random", "list"), ("clamped BCE", "list"), ("k 0", "staged"),
    ("k past the count", "staged"), ("all zero", "device memory"),
    ("tiny values", "device memory")])
def test_the_sum_reads_the_list_when_it_holds_every_value_above_lo(
        case, source):
    """The sum reads the list where every value left out of it is at most
    lo; the staged values where no list was made (k of 0, k past the
    count); the slice in device memory again where lo lies below the
    pass-0 bucket (v = 0 in a map of zeros; tiny values, whose bracket
    after 34 rounds is wider than they are)."""
    values, k = _maps()[case]
    got = _hold_cooperative(values, k, LAUNCH_SHAPES["one block, staged"])
    assert got["source"] == source


@pytest.mark.parametrize("case", ["ties at kk", "k 0", "k past the count",
                                  "all zero", "one value", "clamped BCE"])
def test_topk_sum_matches_jax_with_its_gradient(case):
    values, k = _maps()[case]
    ref, ref_grad = jax.value_and_grad(JL._topk_sum)(jnp.asarray(values),
                                                     jnp.float32(k))
    v = torch.from_numpy(values.copy()).requires_grad_()
    got = OH.topk_sum(v, torch.tensor(k, dtype=torch.float32))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(v.grad.numpy(), np.asarray(ref_grad))


def test_ohem_balance_bce_on_clamped_probabilities_matches_jax():
    """Probabilities at 0 and 1 clamp to the same BCE by the thousand: the
    ties the select must keep exact."""
    rs = np.random.RandomState(7)
    shape = (2, 48, 64)
    pred = np.where(rs.rand(*shape) < 0.4, rs.randint(0, 2, shape),
                    rs.rand(*shape)).astype(np.float32)
    gt = (rs.rand(*shape) < 0.1).astype(np.float32)
    mask = (rs.rand(*shape) < 0.9).astype(np.float32)
    ref = JL.ohem_balance_bce(jnp.asarray(pred), jnp.asarray(gt),
                              jnp.asarray(mask), reduction="none")
    got = L.ohem_balance_bce(torch.from_numpy(pred), torch.from_numpy(gt),
                             torch.from_numpy(mask), reduction="none")
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
