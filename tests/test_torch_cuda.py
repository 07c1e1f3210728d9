"""The kernels on the card against their plain PyTorch versions: K3-K8,
P1, the int8 conv, D1 forward and backward and K10, OHEM's top-k select
(CUDA), and K1, K2 forward and K2 backward and the DB head's train-mode
tail, forward and backward (Triton); the int8 forward on the card against
the CPU.

Needs an NVIDIA GPU, nvcc and Triton; skipped elsewhere. This file imports no JAX,
so it runs on the GPU machine, which has none, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from db_text_minimal_tpu_torch.ops import cc
from db_text_minimal_tpu_torch.ops import db_step as D
from db_text_minimal_tpu_torch.ops import deform as DF
from db_text_minimal_tpu_torch.ops import int8 as I
from db_text_minimal_tpu_torch.ops import ohem as OH
from torch_scenes import K3_SWEEP, SCENES, k3_sweep_mask, rotated_bars

pytestmark = pytest.mark.cuda

K = 1000


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kernels_match_plain_versions(scene, device):
    prob_np, thresh, box_thresh = SCENES[scene]()
    prob = torch.from_numpy(np.stack([prob_np, prob_np[::-1].copy()])).to(
        device)
    mask = prob > thresh
    cc.reset_launches()
    labels = cc.connected_components(mask)
    assert torch.equal(labels, cc.connected_components_plain(mask))
    bg_labels = cc.connected_components(~mask, 4)
    assert torch.equal(bg_labels, cc.connected_components_plain(~mask, 4))
    keyed, valid_root = cc.compact_slots(labels, K)
    keyed_p, valid_p = cc.compact_slots_plain(labels, K)
    assert torch.equal(keyed, keyed_p) and torch.equal(valid_root, valid_p)
    bg_keyed, _ = cc.compact_slots(bg_labels, K)
    hole = cc.hole_stats(mask, keyed, bg_keyed, prob, K)
    hole_p = cc.hole_stats_plain(mask, keyed, bg_keyed, prob, K)
    assert torch.equal(hole[1], hole_p[1])
    torch.testing.assert_close(hole[0], hole_p[0], rtol=1e-6, atol=1e-6)
    out = cc.rotated_boxes(prob, keyed, valid_root, *hole, K)
    ref = cc.rotated_boxes_plain(prob, keyed, valid_root, *hole_p, K)
    valid = ref[3]
    assert torch.equal(out[3], valid)
    torch.testing.assert_close(out[0][valid], ref[0][valid], rtol=0,
                               atol=1e-3)
    torch.testing.assert_close(out[2], ref[2], rtol=0, atol=1e-6)
    stats = cc.bbox_stats(keyed, prob, K)
    stats_p = cc.bbox_stats_plain(keyed, prob, K)
    assert torch.equal(stats[0], stats_p[0])
    assert torch.equal(stats[2], stats_p[2])
    torch.testing.assert_close(stats[1], stats_p[1], rtol=1e-12, atol=1e-9)
    assert torch.equal(cc.pack_bits(mask), cc.pack_bits_plain(mask))
    assert all(v > 0 for v in cc.LAUNCHES.values()), cc.LAUNCHES


@pytest.mark.parametrize("shape,density", [((37, 53), 0.45), ((130, 97), 0.6),
                                           ((1, 700), 0.5), ((700, 1), 0.7),
                                           ((640, 640), 0.55)])
def test_noise_matches_plain_version(shape, density, device):
    """Noise maps of odd shapes: ragged tiles, many cross-tile merges, more
    components and holes than the K slots (the overflow slot)."""
    rng = np.random.RandomState(7)
    prob = torch.from_numpy(rng.rand(3, *shape).astype(np.float32)).to(device)
    mask = prob > 1.0 - density
    for m, conn in ((mask, 8), (~mask, 4)):
        labels = cc.connected_components(m, conn)
        assert torch.equal(labels, cc.connected_components_plain(m, conn))
        keyed, valid_root = cc.compact_slots(labels, K)
        keyed_p, valid_p = cc.compact_slots_plain(labels, K)
        assert torch.equal(keyed, keyed_p) and torch.equal(valid_root,
                                                           valid_p)
    keyed, valid_root = cc.compact_slots(cc.connected_components(mask), K)
    bg_keyed, _ = cc.compact_slots(cc.connected_components(~mask, 4), K)
    hole = cc.hole_stats(mask, keyed, bg_keyed, prob, K)
    hole_p = cc.hole_stats_plain(mask, keyed, bg_keyed, prob, K)
    assert torch.equal(hole[1], hole_p[1])
    torch.testing.assert_close(hole[0], hole_p[0], rtol=1e-6, atol=1e-6)
    out = cc.rotated_boxes(prob, keyed, valid_root, *hole, K)
    ref = cc.rotated_boxes_plain(prob, keyed, valid_root, *hole_p, K)
    valid = ref[3]
    assert torch.equal(out[3], valid)
    torch.testing.assert_close(out[0][valid], ref[0][valid], rtol=0,
                               atol=1e-3)
    torch.testing.assert_close(out[2], ref[2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 96, 384), (2, 65, 257)])
@pytest.mark.parametrize("name", K3_SWEEP)
def test_connected_components_sweep_matches_plain_version(name, shape,
                                                          device):
    """K3 on its hard masks, both connectivities, bit for bit: whole and
    ragged tiles (32 x 128), each image's noise from its own seed."""
    n, h, w = shape
    mask = torch.from_numpy(np.stack([k3_sweep_mask(name, h, w, seed=i)
                                      for i in range(n)])).to(device)
    cc.reset_launches()
    for conn in (8, 4):
        labels = cc.connected_components(mask, conn)
        assert labels.dtype == torch.int32
        assert torch.equal(labels, cc.connected_components_plain(mask, conn))
    assert cc.LAUNCHES["connected_components_8"] == 1
    assert cc.LAUNCHES["connected_components_4"] == 1


def _sweep_mask(name, shape):
    n, h, w = shape
    return torch.from_numpy(np.stack([k3_sweep_mask(name, h, w, seed=i)
                                      for i in range(n)]))


@pytest.mark.parametrize("shape", [(3, 96, 384), (2, 65, 257), (1, 1, 1)])
@pytest.mark.parametrize("k", [1, 10, 1000])
@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("name", K3_SWEEP)
def test_compact_slots_sweep_matches_plain_version(name, connectivity, k,
                                                   shape, device):
    """K4 on K3's hard masks, both connectivities: one component, none, one
    a pixel (the 4-connected checkerboard), more components than K; tiles
    cut by the image's end; slots and valid roots exact."""
    labels = cc.connected_components(_sweep_mask(name, shape).to(device),
                                     connectivity)
    cc.reset_launches()
    keyed, valid_root = cc.compact_slots(labels, k)
    assert cc.LAUNCHES["compact_slots"] == 1
    assert keyed.dtype == torch.int32 and valid_root.dtype == torch.bool
    keyed_p, valid_p = cc.compact_slots_plain(labels, k)
    assert torch.equal(keyed, keyed_p) and torch.equal(valid_root, valid_p)


def _hole_inputs(name, shape, device):
    """(mask, fg_keyed, bg_keyed, prob, K) by the kernels: a K3 sweep mask,
    a scene (nested ring, diagonal-sealed hole) and its flip, or noise whose
    background components overflow bg slot K."""
    k = K
    if name in SCENES:
        p, thresh, _ = SCENES[name]()
        prob = np.stack([p, p[::-1].copy()])
        mask = torch.from_numpy(prob > thresh)
    elif name == "overflow":
        prob = np.random.RandomState(3).rand(*shape).astype(np.float32)
        mask, k = torch.from_numpy(prob > 0.55), 40
    else:
        mask = _sweep_mask(name, shape)
        prob = np.random.RandomState(0).rand(*shape).astype(np.float32)
    prob, mask = torch.from_numpy(prob).to(device), mask.to(device)
    keyed, _ = cc.compact_slots(cc.connected_components(mask), k)
    bg_keyed, _ = cc.compact_slots(cc.connected_components(~mask, 4), k)
    return mask, keyed, bg_keyed, prob, k


@pytest.mark.parametrize("name,shape", [
    (name, shape) for name in K3_SWEEP + ("overflow",)
    for shape in ((3, 96, 384), (2, 65, 257), (1, 1, 1))]
    + [("nested_ring", None), ("diagonal_hole", None)])
def test_hole_stats_sweep_matches_plain_version(name, shape, device):
    """K6 on K3's hard masks, nested rings, diagonal-sealed holes and noise
    that overflows bg slot K: hole counts exact, hole sums (f64 in atomic
    order, rounded to f32) within 1e-6 of their size."""
    args = _hole_inputs(name, shape, device)
    cc.reset_launches()
    hole_sum, hole_cnt = cc.hole_stats(*args)
    assert cc.LAUNCHES["hole_stats"] == 1
    ref_sum, ref_cnt = cc.hole_stats_plain(*args)
    assert hole_sum.dtype == hole_cnt.dtype == torch.float32
    assert torch.equal(hole_cnt, ref_cnt)
    torch.testing.assert_close(hole_sum, ref_sum, rtol=1e-6, atol=1e-6)
    if name in SCENES:
        assert float(ref_cnt.sum()) > 0


def _k7_inputs(name, shape, k, device):
    """keyed, valid_root, prob, hole_sum and hole_cnt by the kernels (K3 ->
    K4 on a K3 sweep mask, K3/K4 on its 4-connected background -> K6), prob
    from a seed."""
    mask = _sweep_mask(name, shape).to(device)
    prob = torch.from_numpy(
        np.random.RandomState(0).rand(*shape).astype(np.float32)).to(device)
    keyed, valid_root = cc.compact_slots(cc.connected_components(mask), k)
    bg_keyed, _ = cc.compact_slots(cc.connected_components(~mask, 4), k)
    return (keyed, valid_root, prob) + cc.hole_stats(mask, keyed, bg_keyed,
                                                     prob, k)


@pytest.mark.parametrize("shape", [(3, 96, 384), (2, 65, 257), (1, 1, 1)])
@pytest.mark.parametrize("k", [1, 10, 1000])
@pytest.mark.parametrize("name", K3_SWEEP)
def test_bbox_stats_sweep_matches_plain_version(name, k, shape, device):
    """The K7 stats kernel (bbox_stats form) on K3's hard masks: one
    component, none, thousands, more than K; whole and ragged images and
    1x1x1: counts and bboxes exact, prob sums (f64 in atomic order) within
    1e-9 of their size."""
    keyed, _, prob, _, _ = _k7_inputs(name, shape, k, device)
    cc.reset_launches()
    cnt, psum, bbox = cc.bbox_stats(keyed, prob, k)
    assert cc.LAUNCHES["bbox_stats"] == 1
    ref = cc.bbox_stats_plain(keyed, prob, k)
    assert (cnt.dtype, psum.dtype, bbox.dtype) == (torch.int32, torch.float64,
                                                   torch.int32)
    assert torch.equal(cnt, ref[0]) and torch.equal(bbox, ref[2])
    torch.testing.assert_close(psum, ref[1], rtol=0,
                               atol=1e-9 * max(1.0, ref[1].abs().max()))


@pytest.mark.parametrize("shape", [(3, 96, 384), (2, 65, 257), (1, 1, 1)])
@pytest.mark.parametrize("k", [1, 10, 1000])
@pytest.mark.parametrize("name", K3_SWEEP)
def test_poly_stats_sweep_matches_plain_version(name, k, shape, device):
    """The K7 stats kernel with the polygon path's epilogue on the same
    inputs: bboxes and valid exact, hole-filled scores within 1e-6 (the f64
    sums in atomic order may round to another f32)."""
    args = _k7_inputs(name, shape, k, device) + (k,)
    cc.reset_launches()
    bboxes, scores, valid = cc.poly_stats(*args)
    assert cc.LAUNCHES["bbox_stats"] == 1
    ref = cc.poly_stats_plain(*args)
    assert (bboxes.dtype, scores.dtype, valid.dtype) == (
        torch.int32, torch.float32, torch.bool)
    assert torch.equal(bboxes, ref[0]) and torch.equal(valid, ref[2])
    torch.testing.assert_close(scores, ref[1], rtol=0, atol=1e-6)


def test_repeated_calls_give_the_first_result(device):
    """50 back-to-back calls of K4, K6, the K7 stats in both forms and the
    K7 bit-pack on one input of the serving size (noise near the
    percolation threshold, 8x640x640): every slot map, valid root, hole
    count, pixel count, bbox, valid flag and packed byte equal to the first
    call's, every hole sum, prob sum and score within 1e-6 of it (f64 sums
    in atomic order). Catches races in the look-back, in the ranks written
    in place and in the last block's epilogue."""
    rng = np.random.RandomState(5)
    prob = torch.from_numpy(rng.rand(8, 640, 640).astype(np.float32))
    prob = prob.to(device)
    mask = prob > 0.45
    labels = cc.connected_components(mask)
    bg_labels = cc.connected_components(~mask, 4)
    first = cc.compact_slots(labels, K)
    bg_keyed, _ = cc.compact_slots(bg_labels, K)
    holes = cc.hole_stats(mask, first[0], bg_keyed, prob, K)
    assert torch.equal(first[0], cc.compact_slots_plain(labels, K)[0])
    runs = [(cc.compact_slots(labels, K),
             cc.hole_stats(mask, first[0], bg_keyed, prob, K))
            for _ in range(50)]
    for (keyed, valid_root), (hole_sum, hole_cnt) in runs:
        assert torch.equal(keyed, first[0])
        assert torch.equal(valid_root, first[1])
        assert torch.equal(hole_cnt, holes[1])
        torch.testing.assert_close(hole_sum, holes[0], rtol=1e-6, atol=1e-6)
    k7_args = (first[0], first[1], prob) + holes + (K,)
    stats = cc.bbox_stats(first[0], prob, K)
    poly = cc.poly_stats(*k7_args)
    packed = cc.pack_bits(mask)
    assert torch.equal(stats[0], cc.bbox_stats_plain(first[0], prob, K)[0])
    assert torch.equal(packed, cc.pack_bits_plain(mask))
    runs = [(cc.bbox_stats(first[0], prob, K), cc.poly_stats(*k7_args),
             cc.pack_bits(mask)) for _ in range(50)]
    for (cnt, psum, bbox), (bboxes, scores, valid), bits in runs:
        assert torch.equal(cnt, stats[0]) and torch.equal(bbox, stats[2])
        torch.testing.assert_close(psum, stats[1], rtol=1e-6, atol=1e-6)
        assert torch.equal(bboxes, poly[0]) and torch.equal(valid, poly[2])
        torch.testing.assert_close(scores, poly[1], rtol=1e-6, atol=1e-6)
        assert torch.equal(bits, packed)


def _assert_k5_matches_plain(args):
    """K5 on the card against its plain version on the same inputs: valid
    exact, corners and sides within 1e-3 px, scores within 1e-6."""
    cc.reset_launches()
    out = cc.rotated_boxes(*args)
    assert cc.LAUNCHES["rotated_boxes"] == 1
    ref = cc.rotated_boxes_plain(*args)
    valid = ref[3]
    assert torch.equal(out[3], valid)
    for i in (0, 1):
        torch.testing.assert_close(out[i][valid], ref[i][valid], rtol=0,
                                   atol=1e-3)
    torch.testing.assert_close(out[2], ref[2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 96, 384), (2, 65, 257)])
@pytest.mark.parametrize("name", K3_SWEEP + ("bars",))
def test_rotated_boxes_sweep_matches_plain_version(name, shape, device):
    """K5 along the rect path (K3 -> K4 -> K3/K4 on the background -> K6)
    on K3's hard masks with prob drawn from a seed, and on rotated bars
    (first-minimum ties near 0 degrees), whole and ragged."""
    n, h, w = shape
    if name == "bars":
        prob = np.stack([rotated_bars(h, w, seed=i) for i in range(n)])
        mask = prob > 0.3
    else:
        mask = np.stack([k3_sweep_mask(name, h, w, seed=i) for i in range(n)])
        prob = np.random.RandomState(0).rand(n, h, w).astype(np.float32)
    prob = torch.from_numpy(prob).to(device)
    mask = torch.from_numpy(mask).to(device)
    keyed, valid_root = cc.compact_slots(cc.connected_components(mask), K)
    bg_keyed, _ = cc.compact_slots(cc.connected_components(~mask, 4), K)
    hole = cc.hole_stats(mask, keyed, bg_keyed, prob, K)
    _assert_k5_matches_plain((prob, keyed, valid_root) + hole + (K,))


def test_rotated_boxes_on_any_slot_map(device):
    """K5 on a slot map drawn at random: slots scattered over the image,
    with rows of their span that hold no pixel, and slots with no pixel."""
    rng = np.random.RandomState(11)
    k = 30
    keyed = rng.randint(0, k + 1, (2, 53 * 71)).astype(np.int32)
    keyed[keyed % 7 == 3] = k
    args = (rng.rand(2, 53, 71).astype(np.float32), keyed, rng.rand(2, k) < .8,
            rng.rand(2, k).astype(np.float32),
            rng.randint(0, 5, (2, k)).astype(np.float32))
    _assert_k5_matches_plain(tuple(torch.from_numpy(a).to(device)
                                   for a in args) + (k,))


def test_device_boxes_on_the_card_match_the_cpu(device):
    prob, thresh, box_thresh = SCENES["speckles"]()
    on_cpu = cc.device_boxes(torch.from_numpy(prob)[None], thresh=thresh,
                             box_thresh=box_thresh)
    on_card = cc.device_boxes(torch.from_numpy(prob)[None].to(device),
                              thresh=thresh, box_thresh=box_thresh)
    keep = on_cpu[2]
    assert torch.equal(on_card[2].cpu(), keep)
    torch.testing.assert_close(on_card[0].cpu()[keep], on_cpu[0][keep],
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("scene", sorted(SCENES) + ["width100"])
def test_device_poly_stats_on_the_card_match_the_cpu(scene, device):
    """K7 end to end (both K3 passes, K4 twice, K6, the bbox stats and the
    bit-pack) on the card against the same call on the CPU: packed bitmap,
    bboxes and valid exact, scores within 1e-6."""
    if scene == "width100":
        prob = np.random.RandomState(3).rand(3, 100, 100).astype(np.float32)
        thresh = 0.6
    else:
        prob, thresh, _ = SCENES[scene]()
        prob = np.stack([prob, prob[::-1].copy()])
    cc.reset_launches()
    on_card = cc.device_poly_stats(torch.from_numpy(prob).to(device), thresh)
    on_cpu = cc.device_poly_stats(torch.from_numpy(prob), thresh)
    assert cc.LAUNCHES["bbox_stats"] == cc.LAUNCHES["pack_bits"] == 1
    for i in (0, 1, 3):
        assert torch.equal(on_card[i].cpu(), on_cpu[i])
    torch.testing.assert_close(on_card[2].cpu(), on_cpu[2], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("width", [1, 7, 8, 9, 16, 100, 640, 641])
def test_pack_bits_widths_match_plain_version(width, device):
    """The bit-pack at widths that take the word path (W % 8 == 0) and the
    row path, on bool masks, on uint8 masks whose set bytes are 1, 2, 127
    or 255, and on a view of those bytes one byte into a buffer, so that
    its base is not 16-byte aligned: the kernel's scalar path, exact all
    the same."""
    rng = np.random.RandomState(width)
    mask = torch.from_numpy(rng.rand(3, 33, width) < 0.5).to(device)
    assert torch.equal(cc.pack_bits(mask), cc.pack_bits_plain(mask))
    values = rng.choice(np.array([0, 0, 1, 2, 127, 255], np.uint8),
                        (3, 33, width))
    bytes_ = torch.from_numpy(values).to(device)
    assert torch.equal(cc.pack_bits(bytes_), cc.pack_bits_plain(bytes_))
    flat = torch.cat([bytes_.new_zeros(1), bytes_.flatten()])
    view = flat[1:].view(bytes_.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    cc.reset_launches()
    assert torch.equal(cc.pack_bits(view), cc.pack_bits_plain(view))
    assert cc.LAUNCHES["pack_bits"] == 1


def test_fast_boxes_on_the_card_match_the_cpu(device):
    for name in ("speckles", "serpentine"):
        prob, thresh, box_thresh = SCENES[name]()
        on_cpu = cc.fast_boxes(torch.from_numpy(prob)[None], thresh,
                               box_thresh)
        on_card = cc.fast_boxes(torch.from_numpy(prob)[None].to(device),
                                thresh, box_thresh)
        assert torch.equal(on_card[0].cpu(), on_cpu[0])
        assert torch.equal(on_card[2].cpu(), on_cpu[2])
        torch.testing.assert_close(on_card[1].cpu(), on_cpu[1], rtol=0,
                                   atol=1e-6)


def test_device_poly_representer_on_the_card_matches_the_cpu(device):
    from db_text_minimal_tpu_torch.postprocess import DevicePolyRepresenter

    maps = np.stack([SCENES[s]()[0][:128, :128]
                     for s in ("rot_rect", "nested_ring", "speckles")])
    batch = {"shape": [(256, 192)] * 3}
    rep = DevicePolyRepresenter(thresh=0.3, box_thresh=0.5)
    ref_b, ref_s = rep(batch, torch.from_numpy(maps))
    got_b, got_s = rep(batch, torch.from_numpy(maps).to(device))
    assert sum(len(b) for b in ref_b) >= 3
    for gb, rb, gs, rs in zip(got_b, ref_b, got_s, ref_s):
        assert len(gb) == len(rb)
        for a, b in zip(gb, rb):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(gs, rs, rtol=0, atol=1e-6)


def _maps(device, shape=(4, 1, 640, 640), seed=0):
    """P and T from a seed, with the ends of k(P - T) = ±50 and values at
    the bitmap's threshold included."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(shape, generator=g)
    t = torch.rand(shape, generator=g)
    n = min(4, p.numel())
    p.view(-1)[:n] = torch.tensor([1.0, 0.0, 0.3, 0.30000001])[:n]
    t.view(-1)[:n] = torch.tensor([0.0, 1.0, 0.3, 0.3])[:n]
    return p.to(device), t.to(device)


@pytest.mark.parametrize("shape", [(4, 640, 640), (3, 37, 53), (1, 1, 1)])
def test_fused_db_step_matches_plain_version(shape, device):
    p, t = _maps(device, shape)
    D.reset_launches()
    bhat, bitmap = D.fused_db_step(p, t, 50.0, 0.3)
    ref_b, ref_m = D.fused_db_step_plain(p, t, 50.0, 0.3)
    assert D.LAUNCHES["fused_db_step"] == 1
    torch.testing.assert_close(bhat, ref_b, rtol=0, atol=1e-6)
    assert torch.equal(bitmap, ref_m)


@pytest.mark.parametrize("shape", [(4, 1, 640, 640), (2, 1, 33, 65)])
def test_db_step_forward_matches_plain_version(shape, device):
    p, t = _maps(device, shape, seed=1)
    D.reset_launches()
    bhat = D.db_step_forward(p, t, 50.0)
    assert D.LAUNCHES["db_step_forward"] == 1
    torch.testing.assert_close(bhat, D.db_step_forward_plain(p, t, 50.0),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(bhat.view(-1)[:2], torch.tensor(
        [1.0, 0.0], device=device), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        D.db_step_forward(p.transpose(2, 3), t.transpose(2, 3), 50.0)


@pytest.mark.parametrize("layout", ["nhwc_channel", "contiguous",
                                    "transposed"])
def test_db_step_backward_matches_plain_version(layout, device):
    """The gradient as the loss hands it over (the last channel of an NHWC
    view, element stride 3), contiguous, and in a layout of no uniform
    stride, which the wrapper copies first."""
    p, t = _maps(device, seed=2)
    bhat = D.db_step_forward(p, t, 50.0)
    g = torch.randn((4, 640, 640, 3), generator=torch.Generator()
                    .manual_seed(3)).to(device) * 4
    g = {"nhwc_channel": g.permute(0, 3, 1, 2)[:, 2:3],
         "contiguous": g[..., 2].unsqueeze(1).contiguous(),
         "transposed": g[..., 2].unsqueeze(1).contiguous()
         .transpose(2, 3).contiguous().transpose(2, 3)}[layout]
    D.reset_launches()
    dp, dt = D.db_step_backward(g, bhat, 50.0)
    ref_p, ref_t = D.db_step_backward_plain(g, bhat, 50.0)
    assert D.LAUNCHES["db_step_backward"] == 1
    tol = 1e-6 * max(1.0, g.abs().max().item())
    torch.testing.assert_close(dp, ref_p, rtol=0, atol=tol)
    torch.testing.assert_close(dt, ref_t, rtol=0, atol=tol)


def test_db_step_autograd_on_the_card(device):
    """The train-mode head's path: cat, NHWC view, a loss on the last
    channel; K2 forward and backward each launch once."""
    p, t = _maps(device, (2, 1, 64, 96), seed=4)
    p.requires_grad_()
    t.requires_grad_()
    w = torch.rand((2, 64, 96), device=device)
    D.reset_launches()
    out = torch.cat([p, t, D.db_step(p, t, 50.0)], 1).permute(0, 2, 3, 1)
    gp, gt = torch.autograd.grad((out[..., 2] * w).sum(), (p, t))
    assert D.LAUNCHES["db_step_forward"] == D.LAUNCHES[
        "db_step_backward"] == 1
    plain = torch.cat([p, t, D.db_step_plain(p, t, 50.0)], 1)
    rp, rt = torch.autograd.grad((plain.permute(0, 2, 3, 1)[..., 2]
                                  * w).sum(), (p, t))
    # torch's sigmoid backward rounds g·σ(1−σ)·k, K2 g·(k·σ·(1−σ))
    torch.testing.assert_close(gp, rp, rtol=0, atol=1e-5)
    torch.testing.assert_close(gt, rt, rtol=0, atol=1e-5)


def _tail_inputs(device, dtype, shape=(4, 1, 640, 640), seed=5):
    """The head's last deconv outputs as the step gives them (N, 1, H, W),
    with sigmoids saturated at both ends, and the output's gradient as the
    step hands it over: the (N, 3, H, W) view of an NHWC tensor."""
    g = torch.Generator().manual_seed(seed)
    zb = torch.randn(shape, generator=g) * 4
    zt = torch.randn(shape, generator=g) * 4
    ends = min(4, zb.numel())
    zb.view(-1)[:ends] = torch.tensor([0.0, 100.0, -100.0, 1e-30])[:ends]
    n, _, h, w = shape
    grad = torch.randn((n, h, w, 3), generator=g).permute(0, 3, 1, 2)
    return zb.to(dtype).to(device), zt.to(dtype).to(device), grad.to(device)


@pytest.mark.parametrize("shape", [(4, 1, 640, 640), (3, 1, 33, 65),
                                   (1, 1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_db_tail_matches_the_composition_it_replaces(shape, dtype, device):
    """The tail's forward against its plain version (f32 casts and
    sigmoids, K2, the concatenation): P and T equal, B̂ within 1e-6; its
    backward bit-equal to that composition's autograd with the gradient at
    the step's strides, contiguous, and in a layout it copies first, and
    in the composition's layout for the first two."""
    zb, zt, grad = _tail_inputs(device, dtype, shape)
    D.reset_launches()
    out = D.db_tail_forward(zb, zt, 50.0)
    ref = D.db_tail_plain(zb, zt, 50.0)
    assert D.LAUNCHES["db_tail_forward"] == 1
    assert out.shape == ref.shape and out.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(out[:, :2], ref[:, :2])
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    leaf_b, leaf_t = zb.clone().requires_grad_(), zt.clone().requires_grad_()
    composed = D.db_tail_plain(leaf_b, leaf_t, 50.0)
    for name, layout in (("step", grad), ("contiguous", grad.contiguous()),
                         ("transposed", grad.transpose(2, 3).contiguous()
                          .transpose(2, 3))):
        want = torch.autograd.grad(composed, (leaf_b, leaf_t), layout,
                                   retain_graph=True)
        D.reset_launches()
        got = D.db_tail_backward(layout, zb, zt, 50.0)
        assert D.LAUNCHES["db_tail_backward"] == 1
        for a, b in zip(got, want):
            assert a.dtype == dtype and torch.equal(a, b)
            # the layout the composition gives the deconv's backward (which
            # follows a transposed gradient's; the tail's is contiguous)
            assert name == "transposed" or a.stride() == b.stride()


def test_db_tail_trains_the_head_on_the_card(device):
    """A train-mode DBHead on the card: the tail's kernels once each, K2
    never; the same output as the head on the CPU (fp32, TF32 off) within
    1e-5, and the same gradients within 1e-4 of the largest of them (sums
    of 3,200 products in cuDNN's order and the CPU's; the conv biases
    before a train-mode BN have a true gradient of 0 and read that noise
    alone)."""
    from db_text_minimal_tpu_torch.models.head import DBHead

    torch.manual_seed(0)
    head = DBHead(64, 16).train()
    x = torch.randn(2, 64, 40, 40)
    runs = []
    for dev in (torch.device("cpu"), device):
        model = copy.deepcopy(head).to(dev)
        xd = x.to(dev).detach().requires_grad_()
        D.reset_launches()
        with torch.backends.cudnn.flags(allow_tf32=False):
            out = model(xd)
            (out * out.detach()).sum().backward()
        if dev.type == "cuda":
            assert (D.LAUNCHES["db_tail_forward"]
                    == D.LAUNCHES["db_tail_backward"] == 1)
            assert not (D.LAUNCHES["db_step_forward"]
                        or D.LAUNCHES["db_step_backward"])
        runs.append([out, xd.grad] + [p.grad for p in model.parameters()])
    torch.testing.assert_close(runs[1][0].cpu(), runs[0][0], rtol=0,
                               atol=1e-5)
    scale = max(a.abs().max().item() for a in runs[0][1:])
    for a, b in zip(runs[0][1:], runs[1][1:]):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-4 * scale)


def _ohem_map(name, device, n=4 * 640 * 640):
    """Maps of tied values: clamped BCE at -log(1e-7) on 30 % of the
    pixels, four values, zeros; a 32x640x640 map (52 MB, more than the
    grid's shared memory holds) of clamped BCE and four values; and maps
    smaller than one block's share of the grid."""
    if name == "32x640x640":
        return torch.cat([_ohem_map(part, device, 16 * 640 * 640)
                          for part in ("clamped", "four")])
    if name in ("one", "thousand"):
        size = 1 if name == "one" else 1000
        return torch.from_numpy(np.random.RandomState(13).rand(size)
                                .astype(np.float32)).to(device)
    rs = np.random.RandomState(11)
    clamped = np.where(rs.rand(n) < 0.3, -np.log(np.float32(1e-7)),
                       rs.rand(n) * 2).astype(np.float32)
    four = rs.choice(np.float32([0.0, 0.1053, 0.6931, 16.118]), n)
    maps = {"clamped": clamped, "four": four,
            "zeros": np.zeros(n, np.float32),
            "odd": rs.rand(1001).astype(np.float32)}
    return torch.from_numpy(maps[name]).to(device)


def _hold_k10(values, k):
    OH.reset_launches()
    out, lo = OH.topk_select(values, k)
    assert OH.LAUNCHES["ohem_topk_sum"] == 1
    lo_p = OH.bisection_lo(values, k)
    assert torch.equal(lo, lo_p), (lo.item(), lo_p.item())
    ref = OH.topk_sum_plain(values, k).item()
    assert abs(out.item() - ref) <= 1e-5 * OH.sum_scale(values, lo_p, k)
    return out, lo


@pytest.mark.parametrize("k", [0.0, 1.0, 1234.5, 383_999.0, 384_000.0,
                               1e6, 1_638_400.0, 2e6])
@pytest.mark.parametrize("name", ["clamped", "four", "zeros", "odd",
                                  "32x640x640", "one", "thousand"])
def test_topk_select_gives_the_bisection_lo(name, k, device):
    """lo bit-equal to the bisection's, the sum within 1e-5 of the size of
    its two terms (they cancel where values tie at lo: f64 against torch's
    f32), on tie-heavy maps, with k of 0, inside a run of ties, at and past
    the count, on a map larger than the grid's shared memory and on maps
    smaller than one block's share; then 50 calls on one scratch, filled
    with ones at first, bit-equal to the first (the kernel zeroes its own
    state)."""
    values = _ohem_map(name, device)
    kv = torch.tensor(k, device=device)
    out, lo = _hold_k10(values, kv)
    # an unaligned start (the scalar head)
    if values.numel() > 1:
        _hold_k10(values[1:], torch.tensor(min(k, 500.0), device=device))
    scratch = torch.full((OH.load_library().ohem_state_bytes(),), 255,
                         dtype=torch.uint8, device=device)
    for _ in range(50):
        again, lo_again = OH.topk_select(values, kv, state=scratch)
        assert torch.equal(again, out) and torch.equal(lo_again, lo)


def test_topk_select_on_a_train_step_loss_map(device):
    """The OHEM map of a full-width model's bf16 train-mode forward at
    640x640 (a seeded resnet18 + FPN + DBHead): lo bit-equal, the sum
    within 1e-5 of its terms' size, the gradient equal to the
    bisection's."""
    from db_text_minimal_tpu_torch import losses as L
    from db_text_minimal_tpu_torch.data.scenes import text_batch
    from db_text_minimal_tpu_torch.models import DBTextModel
    from db_text_minimal_tpu_torch.train import trainer as T

    model = DBTextModel(compute_dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device).train()
    batch = T.device_preprocess(T.to_device(text_batch(0, 2, 640), device))
    with torch.no_grad():
        preds = model(batch["img"])
    gt, mask = batch["prob_map"], batch["supervision_mask"]
    negative = (1.0 - gt) * mask
    k = torch.minimum((gt * mask).sum() * 3.0, negative.sum())
    values = (L._bce(preds[..., 0], gt) * negative).contiguous()
    _hold_k10(values, k)
    leaf = values.clone().requires_grad_()
    (got,) = torch.autograd.grad(OH.topk_sum(leaf, k), leaf)
    assert OH.LAUNCHES["ohem_topk_grad"] == 1
    leaf_p = values.clone().requires_grad_()
    (want,) = torch.autograd.grad(OH.topk_sum_plain(leaf_p, k), leaf_p)
    assert torch.equal(got, want)


def test_train_step_launches_the_tail_and_k10(device):
    """One bf16 train step of the default configuration at 640x640, batch
    2: the tail's forward and backward and K10's select and gradient once
    each, K1 and K2 never; K10's select one device operation a call."""
    from db_text_minimal_tpu_torch.config import default_config
    from db_text_minimal_tpu_torch.data.scenes import text_batch
    from db_text_minimal_tpu_torch.train import trainer as T

    cfg = default_config()
    cfg.logging.logger_file = None
    cfg.hps.img_size, cfg.hps.batch_size = 640, 2
    state = T.Trainer(cfg).init_state()
    batch = T.to_device(text_batch(0, 2, 640), device)
    step = T.build_train_step(cfg)
    step(state, batch, 0.005)
    D.reset_launches()
    OH.reset_launches()
    _, out, _, _ = step(state, batch, 0.005)
    torch.cuda.synchronize()
    assert np.isfinite(out.total_loss.item())
    assert D.LAUNCHES == {"fused_db_step": 0, "db_step_forward": 0,
                          "db_step_backward": 0, "db_tail_forward": 1,
                          "db_tail_backward": 1}
    assert OH.LAUNCHES == {"ohem_topk_sum": 1, "ohem_topk_grad": 1}
    # the select is one device operation a call: no memset, one kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    values = _ohem_map("clamped", device)
    kv = torch.tensor(1234.5, device=device)
    OH.topk_select(values, kv)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            OH.topk_select(values, kv)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(ops) == 3 and all("k10_select" in name for name in ops), ops


def test_cuda_tensors_never_reach_a_plain_version(device, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("db_tail_plain", "db_tail_backward_plain",
                 "db_step_forward_plain", "db_step_backward_plain"):
        monkeypatch.setattr(D, name, refuse)
    for name in ("topk_sum_plain", "bisection_lo"):
        monkeypatch.setattr(OH, name, refuse)
    zb, zt, _ = _tail_inputs(device, torch.bfloat16, (2, 1, 64, 64))
    zb.requires_grad_()
    D.db_tail(zb, zt).sum().backward()
    v = torch.rand(4096, device=device).requires_grad_()
    OH.topk_sum(v, torch.tensor(100.0, device=device)).backward()
    assert zb.grad is not None and v.grad is not None


def _epilogue_inputs(m, c, device, seed=0):
    """int32 accumulators over the range of a 3x3 conv of 256 int8
    channels (|acc| <= 2304 * 127^2 < 2^26), scales and biases as a
    calibrated conv has them."""
    g = torch.Generator().manual_seed(seed)
    acc = torch.randint(-2 ** 25, 2 ** 25, (m, c), generator=g,
                        dtype=torch.int32)
    scale = torch.rand(c, generator=g) * 2e-6
    bias = torch.randn(c, generator=g) * 0.5
    return acc.to(device), scale.to(device), bias.to(device)


@pytest.mark.parametrize("c", [128, 256, 512])
@pytest.mark.parametrize("form", ["f32_relu", "f32", "int8"])
def test_int8_epilogue_matches_plain_version(c, form, device):
    """P1 bit for bit against its plain version on the card, at the
    forward's channel counts and at M = 4099 (the grid-stride loop's last
    pass is ragged)."""
    acc, scale, bias = _epilogue_inputs(4099, c, device, seed=c)
    relu = form != "f32"
    out_scale = (torch.tensor(4.0 / 127.0, device=device) if form == "int8"
                 else None)
    I.reset_launches()
    got = I.int8_epilogue(acc, scale, bias, relu, out_scale)
    torch.cuda.synchronize()
    ref = I.int8_epilogue_plain(acc, scale, bias, relu, out_scale)
    assert got.dtype == ref.dtype == (torch.int8 if form == "int8"
                                      else torch.float32)
    assert torch.equal(got, ref)
    assert I.LAUNCHES["int8_epilogue"] == 1
    assert I.LAUNCHES["int8_epilogue_int8" if form == "int8"
                      else "int8_epilogue_f32"] == 1
    if form == "int8":   # relu, then clipped at 127
        assert set(torch.unique(got).tolist()) >= {0, 127}


def test_int8_epilogue_refuses_on_the_card(device):
    acc, scale, bias = _epilogue_inputs(64, 132, device)
    with pytest.raises(ValueError, match="multiple of 4"):
        I.int8_epilogue(acc[:, :130].contiguous(), scale[:130], bias[:130],
                        True)
    with pytest.raises(ValueError, match="contiguous"):
        I.int8_epilogue(acc[:, :128], scale[:128], bias[:128], True)
    with pytest.raises(ValueError, match="aligned"):
        I.int8_epilogue(acc[:, :128].contiguous(), scale[1:129],
                        bias[:128], True)


@pytest.mark.parametrize("k,stride,pad,cin", [(3, 1, 1, 256), (3, 2, 1, 64),
                                              (1, 2, 0, 64), (3, 1, 1, 512)])
def test_int8_conv2d_on_the_card_matches_the_cpu(k, stride, pad, cin,
                                                 device):
    """im2col and ``torch._int_mm`` on the card (cuBLASLt's int8 path) at
    the forward's depths K = k*k*Cin, exact against the CPU."""
    g = torch.Generator().manual_seed(k * cin + stride)
    q = torch.randint(-127, 128, (2, 20, 20, cin), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (256, k * k * cin), generator=g,
                      dtype=torch.int8)
    ref = I.int8_conv2d(q, w, k, stride, pad)
    got = I.int8_conv2d(q.to(device), w.to(device), k, stride, pad)
    assert torch.equal(got.cpu(), ref)


# the int8 forward's convs at batch 8, 640x640, with skip=(): (input size,
# Cin, Cout, k, stride, forms); the int8 form where a static forward feeds
# the next conv (the blocks' conv1, the FPN output conv)
INT8_CONV_SHAPES = [(160, 64, 128, 3, 2, "both"), (80, 128, 128, 3, 1, "both"),
                    (160, 64, 128, 1, 2, "f32"), (80, 128, 256, 3, 2, "both"),
                    (40, 256, 256, 3, 1, "both"), (80, 128, 256, 1, 2, "f32"),
                    (40, 256, 512, 3, 2, "both"), (20, 512, 512, 3, 1, "both"),
                    (40, 256, 512, 1, 2, "f32"), (160, 256, 256, 3, 1, "both"),
                    (160, 256, 128, 3, 1, "f32")]


def _conv_inputs(n, size, cin, cout, k, device, seed=0, width=None):
    """int8 NHWC input, (kh, kw, cin) weights padded by ``pad_cols`` where
    a width asks for it, per-row scales and biases (zero on padded rows),
    on the card."""
    g = torch.Generator().manual_seed(seed)
    width = width or size
    q = torch.randint(-127, 128, (n, size, width, cin), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, k * k * cin), generator=g,
                      dtype=torch.int8)
    padded = I.pad_cols(w.numpy())
    w = w if padded is None else torch.from_numpy(padded)
    rows = w.shape[0]
    scale = torch.zeros(rows)
    bias = torch.zeros(rows)
    scale[:cout] = torch.rand(cout, generator=g) * 2e-6
    bias[:cout] = torch.randn(cout, generator=g) * 0.5
    return q.to(device), w.to(device), scale.to(device), bias.to(device)


def _hold_int8_conv(q, w, k, stride, pad, scale, bias, relu, out_scale):
    """The kernel once, bit for bit against the plain route on the card
    (im2col, ``torch._int_mm``, P1's plain version), one launch of its
    form."""
    I.reset_launches()
    got = I.int8_conv(q, w, k, stride, pad, scale, bias, relu, out_scale)
    torch.cuda.synchronize()
    ref = I.int8_conv_plain(q, w, k, stride, pad, scale, bias, relu,
                            out_scale)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref)
    form = "int8_conv_f32" if out_scale is None else "int8_conv_int8"
    assert I.LAUNCHES["int8_conv"] == I.LAUNCHES[form] == 1
    return got


def _forms(forms):
    return ["f32", "int8"] if forms == "both" else [forms]


@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("shape", INT8_CONV_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:5])))
def test_int8_conv_matches_plain_route_at_forward_shapes(shape, batch,
                                                         device):
    """The int8 conv kernel (implicit GEMM on the tensor cores, P1's
    epilogue in registers) is ``torch.equal`` to im2col + ``torch._int_mm``
    + P1's plain version at every conv shape of the int8 forward, at batch
    8 and 1, in each form the forward uses (the int8 form at an output
    scale that clips)."""
    size, cin, cout, k, stride, forms = shape
    pad = k // 2
    q, w, scale, bias = _conv_inputs(batch, size, cin, cout, k, device,
                                     seed=size + cin + k)
    for form in _forms(forms):
        out_scale = (torch.tensor(0.005, device=device) if form == "int8"
                     else None)
        got = _hold_int8_conv(q, w, k, stride, pad, scale, bias, True,
                              out_scale)
        if form == "int8":
            assert got.max() == 127


@pytest.mark.parametrize("cin,cout,k,stride", [
    (77, 256, 3, 1), (256, 154, 3, 2), (192, 130, 3, 1), (37, 24, 3, 1),
    (130, 256, 1, 2), (8, 136, 3, 2), (48, 128, 3, 1)])
@pytest.mark.parametrize("form", ["f32", "int8"])
def test_int8_conv_matches_plain_route_at_odd_widths(cin, cout, k, stride,
                                                     form, device):
    """Pruned widths (Cin and Cout no multiples of 16, K and Cout padded to
    multiples of 8 by ``pad_cols``) on a ragged M (3 x 17 x 19 pixels):
    bit-equal to the plain route, relu on and off, the padded output
    channels zero; an earlier conv's int8 output at padded rows, sliced to
    its channels, is read in place."""
    q, w, scale, bias = _conv_inputs(3, 17, cin, cout, k, device,
                                     seed=cin + cout, width=19)
    out_scale = torch.tensor(0.005, device=device) if form == "int8" else None
    for relu in (True, False):
        got = _hold_int8_conv(q, w, k, stride, k // 2, scale, bias, relu,
                              out_scale)
        assert not got[..., cout:].any()
    wide = torch.zeros((3, 17, 19, -(-cin // 16) * 16 + 16),
                       dtype=torch.int8, device=device)
    wide[..., :cin] = q
    _hold_int8_conv(wide[..., :cin], w, k, stride, k // 2, scale, bias,
                    True, out_scale)


def test_int8_conv_repeated_calls_are_equal(device):
    """50 back-to-back calls at the FPN output conv's shape (batch 2) give
    the first call's bits."""
    q, w, scale, bias = _conv_inputs(2, 160, 256, 256, 3, device)
    first = I.int8_conv(q, w, 3, 1, 1, scale, bias, True)
    outs = [I.int8_conv(q, w, 3, 1, 1, scale, bias, True)
            for _ in range(50)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)
    assert torch.equal(first, I.int8_conv_plain(q, w, 3, 1, 1, scale, bias,
                                                True))


def test_int8_conv_refuses_on_the_card(device):
    q, w, scale, bias = _conv_inputs(1, 9, 64, 136, 3, device)
    with pytest.raises(ValueError, match="multiple of 8"):
        I.int8_conv(q, w[:130], 3, 1, 1, scale[:130], bias[:130], True)
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        I.int8_conv(q, w, 3, 1, 1, scale.cpu(), bias, True)
    with pytest.raises(ValueError, match="contiguous"):
        I.int8_conv(q, w, 3, 1, 1, torch.stack([scale, scale], 1)[:, 0],
                    bias, True)
    with pytest.raises(TypeError, match="int8 NHWC"):
        I.int8_conv(q.float(), w, 3, 1, 1, scale, bias, True)
    with pytest.raises(ValueError, match="fewer than"):
        I.int8_conv(q, w[:, :64], 3, 1, 1, scale, bias, True)


def _quant_tree(seed=0):
    from db_text_minimal_tpu_torch.models import DBTextModel
    from db_text_minimal_tpu_torch.models import quant_infer as Q

    model = DBTextModel(head_name="FusedDBHead")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return Q.prepare_quant_params(model.state_dict(), skip=())


@pytest.mark.parametrize("float_convs", ["f64", "f32"])
def test_int8_forward_on_the_card_matches_the_cpu(float_convs, device):
    """The calibrated int8 forward (skip=()) on the card against the CPU,
    the float convs in f64 or in f32 (TF32 off) on both: with f64 every
    int8 activation is equal and the maps within 1e-6; with f32 the first
    int8 conv's input agrees at >= 99.9 % of positions. Fused and unfused
    forwards are bit-equal on the card; the int8 conv's kernel launches 7
    times in its int8 form and 10 in its f32 form, P1's never."""
    from db_text_minimal_tpu_torch.models import quant_infer as Q

    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.float64 if float_convs == "f64" else torch.float32
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 128, 128, 3)
                         .astype(np.float32) * 255 - 115)
    qv = Q.calibrate_activation_scales(_quant_tree(), [x[:1]],
                                       compute_dtype=dtype)
    runs = []
    for dev, tree in (("cpu", qv), (device, Q.tree_to(qv, device))):
        inputs = []
        I.reset_launches()
        with torch.inference_mode():
            out = Q.quant_dbnet_forward(tree, x.to(dev), compute_dtype=dtype,
                                        int8_inputs=inputs)
        runs.append((out.cpu(), [q.cpu() for q in inputs],
                     dict(I.LAUNCHES)))
    (ref, ref_q, _), (got, got_q, launches) = runs
    assert launches["int8_conv_int8"] == 7
    assert launches["int8_conv_f32"] == 10
    assert launches["int8_epilogue"] == 0
    assert len(got_q) == len(ref_q) == 17
    if float_convs == "f64":
        assert all(torch.equal(a, b) for a, b in zip(got_q, ref_q))
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    else:
        assert (got_q[0] == ref_q[0]).float().mean().item() >= 0.999
    with torch.inference_mode():
        tree = Q.tree_to(qv, device)
        fused = Q.quant_dbnet_forward(tree, x.to(device))
        plain = Q.quant_dbnet_forward(tree, x.to(device), fuse=False)
    assert torch.equal(fused, plain)


REWRITES = {"s2d": dict(stem_s2d=True), "d2s": dict(deconv_d2s=True),
            "both": dict(stem_s2d=True, deconv_d2s=True)}


@pytest.mark.parametrize("rewrite", sorted(REWRITES))
@pytest.mark.parametrize("mode", ["folded", "int8", "int8_static"])
def test_rewritten_forwards_on_the_card_match_the_plain_ones(mode, rewrite,
                                                             device):
    """The folded and int8 forwards (dynamic scales, and static ones
    calibrated on the first image) with ``stem_s2d``, ``deconv_d2s`` and
    both, in bf16 on the card, against the plain forms of the same mode on
    the same weights: max abs < 2e-2, mean < 1e-3, the JAX package's bound
    for this bf16 comparison (tests/test_pallas_ops.py:348-349). The int8
    forwards launch the int8 conv's kernel 17 times, as the plain ones
    do."""
    from db_text_minimal_tpu_torch.models import DBTextModel
    from db_text_minimal_tpu_torch.models import quant_infer as Q

    model = DBTextModel(head_name="FusedDBHead")
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 128, 128, 3)
                         .astype(np.float32) * 255 - 115).to(device)
    kw = dict(skip=()) if mode.startswith("int8") else dict(
        min_out_channels=10 ** 9)
    outs = []
    for flags in ({}, REWRITES[rewrite]):
        qv = Q.tree_to(Q.prepare_quant_params(sd, **kw, **flags), device)
        if mode == "int8_static":
            qv = Q.calibrate_activation_scales(qv, [x[:1]])
        I.reset_launches()
        with torch.inference_mode():
            outs.append(Q.quant_dbnet_forward(qv, x))
        torch.cuda.synchronize()
        assert I.LAUNCHES["int8_conv"] == (17 if mode != "folded" else 0)
    gap = (outs[1] - outs[0]).abs()
    assert outs[1].shape == (2, 128, 128, 2)
    assert gap.max().item() < 2e-2 and gap.mean().item() < 1e-3


def test_int8_stem_on_the_card_matches_the_cpu(device):
    """The space-to-depth stem as an int8 conv (4x4, Cin 12, pad ((2, 1),
    (2, 1)) by zero-padding the int8 input; thresholds lowered so that it
    and the 64-channel convs are int8) with ``deconv_d2s``, the float
    convs in f64: on the card against the CPU, every int8 activation equal
    and the maps within 1e-6; the int8 conv's kernel takes the stem."""
    from db_text_minimal_tpu_torch.models import DBTextModel
    from db_text_minimal_tpu_torch.models import quant_infer as Q

    model = DBTextModel(head_name="FusedDBHead")
    model.reset_parameters(torch.Generator().manual_seed(0))
    qv = Q.prepare_quant_params(model.state_dict(), skip=(), stem_s2d=True,
                                deconv_d2s=True, min_out_channels=64,
                                min_in_channels=1)
    assert qv["params"]["backbone"]["conv1"]["kernel"].shape == (64, 4, 4, 12)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 128, 128, 3)
                         .astype(np.float32) * 255 - 115)
    runs = []
    for dev, tree in (("cpu", qv), (device, Q.tree_to(qv, device))):
        inputs = []
        I.reset_launches()
        with torch.inference_mode():
            out = Q.quant_dbnet_forward(tree, x.to(dev),
                                        compute_dtype=torch.float64,
                                        int8_inputs=inputs)
        runs.append((out.cpu(), [q.cpu() for q in inputs],
                     I.LAUNCHES["int8_conv"]))
    (ref, ref_q, _), (got, got_q, launches) = runs
    assert launches == len(got_q) == len(ref_q) > 17
    assert got_q[0].shape == (2, 64, 64, 12)
    assert all(torch.equal(a, b) for a, b in zip(got_q, ref_q))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cin,cout", [(77, 256), (256, 154), (192, 130)])
def test_padded_int8_conv2d_on_the_card_matches_the_cpu(cin, cout, device):
    """Pruned widths leave K = 9*Cin or N = Cout off the multiples of 8
    that cuBLASLt's int8 GEMM takes (layer 3's conv2 at Cin 77, layer 4's
    conv1 at 154 outputs, an FPN output conv of 130): the zero-padded
    column matrix (``pad_cols``) on the card gives the CPU's unpadded
    result, exactly."""
    g = torch.Generator().manual_seed(cin + cout)
    q = torch.randint(-127, 128, (2, 20, 20, cin), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, 9 * cin), generator=g,
                      dtype=torch.int8)
    padded = torch.from_numpy(I.pad_cols(w.numpy()))
    assert padded.shape[0] % 8 == 0 and padded.shape[1] % 8 == 0
    ref = I.int8_conv2d(q, w, 3, 1, 1)
    got = I.int8_conv2d(q.to(device), padded.to(device), 3, 1, 1)
    assert torch.equal(got[..., :cout].cpu(), ref)
    assert not got[..., cout:].any()


def test_int8_export_on_the_card_matches_the_live_forward(device, tmp_path):
    """An int8 archive (symbolic batch, uint8 input, prob-only) exported
    and loaded on the card serves batch 1 and 3 with the live int8
    forward's maps (at most 1 % of pixels more than 1e-3 apart), and a
    forward launches the int8 conv's kernel 17 times through the custom
    op."""
    from db_text_minimal_tpu_torch.cli.common import make_folded_forward
    from db_text_minimal_tpu_torch.models import DBTextModel
    from db_text_minimal_tpu_torch.models.head import fuse_variables
    from db_text_minimal_tpu_torch.serve.export import (export_model,
                                                        load_exported)
    from db_text_minimal_tpu_torch.utils import CAFFE_MEAN

    model = DBTextModel()
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = fuse_variables(model.state_dict())
    path = export_model(sd, str(tmp_path / "db.pt2"),
                        input_shape=(None, 128, 128, 3), infer_mode="int8",
                        prob_only=True, device=device)
    infer = load_exported(path, device=device)
    live = make_folded_forward(sd, quantize=True, prob_only=True,
                               device=device)
    mean = torch.tensor(CAFFE_MEAN, device=device)
    g = torch.Generator().manual_seed(1)
    for batch in (1, 3):
        x = torch.randint(0, 256, (batch, 128, 128, 3), generator=g,
                          dtype=torch.uint8).to(device)
        I.reset_launches()
        got = infer(x)
        torch.cuda.synchronize()
        assert I.LAUNCHES["int8_conv"] == 17
        ref = live(x.float() - mean)
        assert got.shape == ref.shape == (batch, 128, 128, 1)
        assert ((got - ref).abs() > 1e-3).float().mean().item() <= 0.01


REC_STAGES = [("None", "VGG", "BiLSTM", "CTC"),
              ("None", "ResNet", "BiLSTM", "Attn"),
              ("TPS", "RCNN", "BiLSTM", "CTC")]


def _recognizer(stages, device):
    from db_text_minimal_tpu_torch.cli.common import _fp32_convolutions
    from db_text_minimal_tpu_torch.models.recognition import \
        RecognitionModel

    _fp32_convolutions()
    model = RecognitionModel(37 if stages[3] == "CTC" else 38, *stages,
                             output_channel=128, hidden_size=64,
                             batch_max_length=10)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device).flatten_parameters()


@pytest.mark.parametrize("stages", REC_STAGES, ids="-".join)
def test_recognizer_forward_on_the_card_matches_the_cpu(stages, device):
    """Seeded recognizer weights, fp32 with TF32 off: the card's logits
    within 1e-4 of the CPU's (the logits of random weights are under 1)."""
    x = torch.rand((8, 32, 100, 1), generator=torch.Generator()
                   .manual_seed(1)) * 2 - 1
    with torch.no_grad():
        got = _recognizer(stages, device).eval()(x.to(device)).cpu()
        ref = _recognizer(stages, "cpu").eval()(x)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("pred", ["CTC", "Attn"])
def test_recognizer_train_step_on_the_card_matches_the_cpu(pred, device):
    """One train step from the same seeded weights and batch: the loss at
    rtol 1e-4, each gradient within 1e-3 of its leaf's max |g| (cuDNN's
    LSTM and CTC backward sum in other orders, the CTC one not
    deterministically), the BN statistics at atol 1e-5 + rtol 1e-4."""
    from db_text_minimal_tpu_torch.train import recognition_trainer as RT

    stages = ("None", "VGG", "BiLSTM", pred)
    g = torch.Generator().manual_seed(2)
    x = torch.rand((4, 32, 100, 1), generator=g) * 2 - 1
    n_class = 37 if pred == "CTC" else 38
    targets = torch.randint(1, n_class, (4, 12), generator=g,
                            dtype=torch.int32)
    lengths = torch.tensor([3, 5, 8, 10], dtype=torch.int32)
    results = []
    for dev in (device, torch.device("cpu")):
        model = _recognizer(stages, dev)
        state = RT.RecTrainState(model, torch.optim.Adam(
            [p for p in model.parameters() if p.requires_grad]))
        loss = RT.build_rec_train_step(state)(
            x.to(dev), targets.to(dev), lengths.to(dev), 1e-3)
        results.append((loss.item(),
                        {n: p.grad.cpu() for n, p in
                         model.named_parameters() if p.grad is not None},
                        {k: v.cpu() for k, v in model.state_dict().items()
                         if "running" in k}))
    (loss_c, grads_c, stats_c), (loss_h, grads_h, stats_h) = results
    assert loss_c == pytest.approx(loss_h, rel=1e-4)
    for name, ref in grads_h.items():
        scale = max(ref.abs().max().item(), 1e-6)
        assert (grads_c[name] - ref).abs().max().item() <= 1e-3 * scale, name
    for name, ref in stats_h.items():
        torch.testing.assert_close(stats_c[name], ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_on_the_card_matches_the_cpu(stride, device):
    """``DeformConv`` (D1's kernels) forward and
    backward on the card against the CPU (D1's plain versions), fp32 with
    TF32 off, offsets of
    several pixels (many taps outside the map): the output and the
    gradients with respect to the input, the offset branch and the kernel
    each within 1e-5 of its largest (the offset convs' f32 sums differ
    between the two and move the samples: the output 1.7e-5 apart at most,
    measured)."""
    from db_text_minimal_tpu_torch.cli.common import _fp32_convolutions
    from db_text_minimal_tpu_torch.models.deform import DeformConv

    _fp32_convolutions()
    g = torch.Generator().manual_seed(stride)
    conv = DeformConv(64, 32, stride)
    with torch.no_grad():
        conv.weight.normal_(0, 0.05, generator=g)
        conv.offset_conv.weight.normal_(0, 0.1, generator=g)
        conv.offset_conv.bias.normal_(0, 1.5, generator=g)
    x = torch.randn((2, 64, 37, 41), generator=g)
    upstream = torch.randn((2, 32, (37 + stride - 1) // stride,
                            (41 + stride - 1) // stride), generator=g)
    results = []
    for dev in (device, torch.device("cpu")):
        conv.to(dev).zero_grad()
        xd = x.to(dev).detach().requires_grad_()
        out = conv(xd)
        (out * upstream.to(dev)).sum().backward()
        results.append([t.detach().cpu() for t in (
            out, xd.grad, conv.offset_conv.weight.grad,
            conv.offset_conv.bias.grad, conv.weight.grad)])
    for got, ref in zip(results[0], results[1]):
        scale = ref.abs().max().item()
        assert scale > 0 and (got - ref).abs().max().item() <= 1e-5 * scale


def test_deformable_resnet18_on_the_card_matches_the_cpu(device):
    """A deformable_resnet18 + FPN forward from seeded weights (offset
    branches random), fp32 with TF32 off: the card's maps within 1e-4 of
    the CPU's. The BN statistics are first set to the batch's (variance
    plus 1, a train-mode pass at momentum 1): with the init's, a random
    deep network's activations, and so its offsets, grow until the maps
    of two summation orders lie 0.15 apart."""
    from db_text_minimal_tpu_torch.cli.common import _fp32_convolutions
    from db_text_minimal_tpu_torch.models import DBTextModel

    _fp32_convolutions()
    model = DBTextModel(backbone_name="deformable_resnet18")
    model.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "offset_conv" in name:
                p.normal_(0, 0.01, generator=g)
    x = torch.rand((2, 128, 128, 3), generator=g) * 255 - 128
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        model(x)
    for m in bns:
        m.running_var += 1.0
    model.eval()
    with torch.no_grad():
        ref = model(x)
        got = model.to(device)(x.to(device)).cpu()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


# ------------------------------------------------------------------ D1 ----

def _deform_inputs(shape, stride, x_dtype, offsets, device, seed=0):
    """NHWC x (normal) and offsets: zero, or normal of std 3 px (many taps
    and corners outside the image)."""
    n, h, w, c = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(x_dtype)
    oh, ow = DF.out_size(h, stride), DF.out_size(w, stride)
    off = torch.zeros((n, oh, ow, 18))
    if offsets == "random":
        off = torch.randn((n, oh, ow, 18), generator=g) * 3
    return x.to(device), off.to(device)


def _within_bf16_ulp(got, ref):
    """Every value within one bf16 ulp of the reference's."""
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= ref.abs() * 2.0 ** -7 + 1e-30).all())


@pytest.mark.parametrize("offsets", ["random", "zero"])
@pytest.mark.parametrize("shape", [(2, 37, 41, 12), (3, 9, 10, 5),
                                   (1, 20, 33, 130), (2, 17, 15, 256)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_deform_kernels_match_plain_versions(x_dtype, dtype, stride, shape,
                                             offsets, device):
    """D1's im2col and col2im against their plain versions at odd sizes:
    f32 columns within 1e-5 of max |x|, bf16 ones within one bf16 ulp;
    dx within 1e-5 and doffsets within 1e-4 of their largest (dx is summed
    by atomics; a bf16 dx may also round to the next ulp)."""
    x, off = _deform_inputs(shape, stride, x_dtype, offsets, device)
    DF.reset_launches()
    cols = DF.deform_im2col(x, off, stride, dtype)
    ref = DF.deform_im2col_plain(x, off, stride, dtype)
    assert cols.dtype == dtype and cols.shape == ref.shape
    if dtype == torch.float32:
        err = (cols - ref).abs().max().item()
        assert err <= 1e-5 * x.abs().max().item(), err
    else:
        assert _within_bf16_ulp(cols, ref)
    g = torch.Generator().manual_seed(1)
    gcols = torch.randn(tuple(cols.shape), generator=g).to(dtype).to(device)
    dx, doff = DF.deform_col2im(x, off, gcols, stride)
    dx_p, doff_p = DF.deform_col2im_plain(x, off, gcols, stride)
    assert dx.dtype == x_dtype and doff.dtype == torch.float32
    scale = dx_p.float().abs().max().item()
    slack = (dx_p.float().abs() * 2.0 ** -7 if x_dtype == torch.bfloat16
             else 0.0)
    assert ((dx.float() - dx_p.float()).abs()
            <= 1e-5 * scale + slack).all()
    err = (doff - doff_p).abs().max().item()
    assert err <= 1e-4 * doff_p.abs().max().item(), err
    assert DF.LAUNCHES == {"deform_im2col": 1, "deform_col2im": 1}


def test_deform_kernels_on_unaligned_tensors(device):
    """A tensor 4 bytes off a 16-byte boundary takes the kernels' one
    channel a lane path: the same results."""
    shape, stride = (2, 21, 19, 64), 1
    x, off = _deform_inputs(shape, stride, torch.float32, "random", device)
    odd = torch.empty(x.numel() + 1, device=device)[1:].view(shape)
    odd.copy_(x)
    assert odd.data_ptr() % 16
    cols = DF.deform_im2col(odd, off, stride, torch.float32)
    assert torch.equal(cols, DF.deform_im2col(x, off, stride, torch.float32))
    gcols = torch.randn_like(cols)
    dx, doff = DF.deform_col2im(odd, off, gcols, stride)
    dx_p, doff_p = DF.deform_col2im_plain(x, off, gcols, stride)
    assert (dx - dx_p).abs().max() <= 1e-5 * dx_p.abs().max()
    assert (doff - doff_p).abs().max() <= 1e-4 * doff_p.abs().max()


def test_deform_kernels_survive_non_finite_offsets(device):
    """NaN, infinite and huge offsets address nothing outside the image
    (a fault would surface at the synchronise): the columns equal the
    plain version's, NaN where it is NaN."""
    x, off = _deform_inputs((2, 9, 10, 8), 1, torch.float32, "zero", device)
    off[0, 0, 0, :4] = torch.tensor([float("nan"), float("inf"),
                                     float("-inf"), 1e30])
    off[1, 2, 3, :2] = torch.tensor([3e9, -3e9])
    cols = DF.deform_im2col(x, off, 1, torch.float32)
    dx, doff = DF.deform_col2im(x, off, torch.ones_like(cols), 1)
    torch.cuda.synchronize()
    ref = DF.deform_im2col_plain(x, off, 1, torch.float32)
    assert torch.equal(cols.isnan(), ref.isnan())
    assert torch.equal(torch.nan_to_num(cols), torch.nan_to_num(ref))
    assert dx[1].isfinite().all() and doff[1].isfinite().all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_conv_on_the_card_launches_d1(dtype, device):
    """A CUDA tensor through ``DeformConv`` reaches D1's kernels: one
    im2col launch a forward, one col2im launch a backward, and the
    three gradients finite."""
    from db_text_minimal_tpu_torch.models.deform import DeformConv

    g = torch.Generator().manual_seed(3)
    conv = DeformConv(128, 64, 2)
    with torch.no_grad():
        conv.offset_conv.weight.normal_(0, 0.1, generator=g)
    conv.compute_dtype = dtype
    conv.to(device)
    x = torch.randn((2, 128, 40, 40), generator=g).to(device).to(
        memory_format=torch.channels_last).requires_grad_()
    DF.reset_launches()
    out = conv(x)
    assert out.dtype == dtype and out.shape == (2, 64, 20, 20)
    assert DF.LAUNCHES == {"deform_im2col": 1, "deform_col2im": 0}
    out.float().square().sum().backward()
    assert DF.LAUNCHES == {"deform_im2col": 1, "deform_col2im": 1}
    for t in (x.grad, conv.weight.grad, conv.offset_conv.weight.grad):
        assert t.isfinite().all() and t.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deformable_export_on_the_card_launches_d1(dtype, device, tmp_path):
    """A flax-mode archive of deformable_resnet18 + FPN (symbolic batch,
    uint8 input) exported and loaded on the card holds D1 as the custom
    op ``dbtext::deform_im2col``: it serves batch 1 and 3 with the live
    forward's maps (at most 1 % of pixels more than 1e-3 apart) and a
    forward launches D1's forward kernel 6 times."""
    from db_text_minimal_tpu_torch.models import DBTextModel
    from db_text_minimal_tpu_torch.serve.export import (export_model,
                                                        load_exported)
    from db_text_minimal_tpu_torch.utils import CAFFE_MEAN

    model = DBTextModel(backbone_name="deformable_resnet18",
                        compute_dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "offset_conv" in name:
                p.normal_(0, 0.01, generator=g)
    model.to(device).eval()
    path = export_model(model, str(tmp_path / "db.pt2"),
                        input_shape=(None, 128, 128, 3), device=device)
    infer = load_exported(path, device=device)
    mean = torch.tensor(CAFFE_MEAN, device=device)
    for batch in (1, 3):
        x = torch.randint(0, 256, (batch, 128, 128, 3), generator=g,
                          dtype=torch.uint8).to(device)
        DF.reset_launches()
        got = infer(x)
        torch.cuda.synchronize()
        assert DF.LAUNCHES == {"deform_im2col": 6, "deform_col2im": 0}
        with torch.no_grad():
            ref = model((x.float() - mean).repeat(2 if batch == 1 else 1,
                                                  1, 1, 1))[:batch]
        assert got.shape == ref.shape == (batch, 128, 128, 2)
        assert got.isfinite().all()
        assert ((got - ref).abs() > 1e-3).float().mean().item() <= 0.01


def _deform_wide_inputs(shape, stride, std, seed):
    """x (normal) and offsets of std ``std`` px, on the CPU."""
    n, h, w, _ = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    off = torch.randn((n, DF.out_size(h, stride), DF.out_size(w, stride),
                       18), generator=g) * std
    return x, off


def _check_col2im(x, off, gcols, stride):
    """dx within 1e-5 and doffsets within 1e-4 of their largest, against
    the plain version (where it is finite)."""
    dx, doff = DF.deform_col2im(x, off, gcols, stride)
    dx_p, doff_p = DF.deform_col2im_plain(x, off, gcols, stride)
    assert torch.isfinite(dx).all() and torch.isfinite(dx_p).all()
    assert (dx - dx_p).abs().max() <= 1e-5 * dx_p.abs().max()
    assert torch.equal(doff.isfinite(), doff_p.isfinite())
    fin = doff_p.isfinite()
    assert (doff[fin] - doff_p[fin]).abs().max() <= \
        1e-4 * doff_p[fin].abs().max()


@pytest.mark.parametrize("std", [1.0, 3.0, 12.0])
@pytest.mark.parametrize("shape", [(2, 37, 53, 40), (1, 37, 53, 6),
                                   (1, 19, 22, 132)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_kernels_match_plain_versions_at_wide_offsets(
        dtype, stride, shape, std, device):
    """D1's kernels at sizes that are no multiple of 8, C no multiple of
    32 (and C % 4 != 0: one channel a lane), batch 1, offsets of std 1, 3
    and 12 px (most samples far from their pixel, many outside the
    image): the columns bit-equal to the plain version's (f32, and bf16
    rounded from the same f32), dx and doffsets within 1e-5 and 1e-4 of
    their largest. The column gradient comes as deform_conv's backward
    hands it over, a (9, P, C) view of a (P, 9, C) tensor."""
    x, off = _deform_wide_inputs(shape, stride, std, seed=int(std))
    x, off = x.to(device), off.to(device)
    DF.reset_launches()
    cols = DF.deform_im2col(x, off, stride, dtype)
    assert torch.equal(cols, DF.deform_im2col_plain(x, off, stride, dtype))
    n, oh, ow, _ = off.shape
    g = torch.Generator().manual_seed(1)
    gcols = torch.randn((n * oh * ow, 9, shape[3]), generator=g).to(
        dtype).to(device).transpose(0, 1)
    _check_col2im(x, off, gcols, stride)
    assert DF.LAUNCHES == {"deform_im2col": 1, "deform_col2im": 1}


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_kernels_survive_scattered_non_finite_offsets(stride,
                                                             device):
    """NaN, infinite and huge offsets among ordinary ones, in several
    places: the columns equal the plain version's (NaN where it is NaN),
    dx and the finite doffsets within the tolerances."""
    x, off = _deform_wide_inputs((2, 37, 53, 40), stride, 3.0, seed=5)
    g = torch.Generator().manual_seed(6)
    pick = torch.rand(off.shape, generator=g)
    bad = torch.tensor([float("nan"), float("inf"), float("-inf"), 1e30,
                        -3e9])
    which = torch.randint(0, len(bad), off.shape, generator=g)
    off = torch.where(pick < 0.03, bad[which], off)
    x, off = x.to(device), off.to(device)
    cols = DF.deform_im2col(x, off, stride, torch.float32)
    torch.cuda.synchronize()
    ref = DF.deform_im2col_plain(x, off, stride, torch.float32)
    assert torch.equal(cols.isnan(), ref.isnan())
    assert torch.equal(torch.nan_to_num(cols), torch.nan_to_num(ref))
    _check_col2im(x, off, torch.randn_like(cols), stride)
