"""The PyTorch port's polygon mode and evaluation against the JAX package,
on the CPU: K7 (``ops.cc.device_poly_stats``) and K8 (``component_boxes``,
``fast_boxes``) through their plain versions, the host and device polygon
representers, ``approx_poly_dp``, DetEval, the offline eval CLIs
(``make_eval``, ``deteval``, ``ioueval``) and the quality bench's
``full_eval``.

Integers (packed bitmaps, bboxes, counts, valid slots, polygons) must be
exactly equal. Scores: the JAX version sums prob in f32 by scatter, the port
in f64, so scores follow ``torch_scenes.score_tol``; device polygon scores
(component plus holes) against the host's filled-contour mean within 2e-3,
the JAX package's own tolerance for that pair.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu import postprocess as jpost
from db_text_minimal_tpu.cli import deteval as jdeteval_cli
from db_text_minimal_tpu.cli import ioueval as jioueval_cli
from db_text_minimal_tpu.cli import make_eval as jmake_eval
from db_text_minimal_tpu.metrics.deteval import \
    DetectionDetEvalEvaluator as JaxDetEval
from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.ops import geometry as jgeo
from db_text_minimal_tpu.ops.pallas import cc as jcc
from db_text_minimal_tpu_torch import postprocess as tpost
from db_text_minimal_tpu_torch.cli import deteval as deteval_cli
from db_text_minimal_tpu_torch.cli import ioueval as ioueval_cli
from db_text_minimal_tpu_torch.cli import make_eval
from db_text_minimal_tpu_torch.cli import quality_bench as qb
from db_text_minimal_tpu_torch.metrics import DetectionDetEvalEvaluator
from db_text_minimal_tpu_torch.ops import cc
from db_text_minimal_tpu_torch.ops import geometry as geo
from db_text_minimal_tpu_torch.weights import state_dict_from_jax
from torch_scenes import K3_SWEEP, SCENES, k3_sweep_mask, score_tol

torch.set_num_threads(1)

K = 1000
POLY_TOL = 2e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def width100():
    """Two text bands on a map 100 pixels wide: rows pack to 13 bytes."""
    rng = np.random.RandomState(3)
    m = np.zeros((100, 100), np.float32)
    m[20:40, 10:90] = rng.uniform(0.7, 0.95, (20, 80))
    m[60:75, 30:61] = rng.uniform(0.6, 0.9, (15, 31))
    return m, 0.3, 0.5


def boxes_map(hi=0.9, size=160):
    """Two filled quads, as ``test_postprocess_metrics._prob_map_with_boxes``
    draws them."""
    pred = np.full((size, size), 0.05, np.float32)
    for box in ([(20, 30), (80, 30), (80, 55), (20, 55)],
                [(100, 90), (150, 95), (148, 120), (98, 115)]):
        geo.fill_poly(pred, np.asarray(box, np.float64), hi)
    return pred


def blobby_map(seed, size=128, n=3):
    """Quads at random probs, half of the wide ones with a hole below
    thresh (``test_postprocess_metrics._blobby_map``)."""
    rng = np.random.RandomState(seed)
    pred = rng.rand(size, size).astype(np.float32) * 0.2
    for _ in range(n):
        w = rng.randint(18, 60)
        h = rng.randint(10, 30)
        x = rng.randint(1, size - w - 1)
        y = rng.randint(1, size - h - 1)
        poly = np.array([[x, y], [x + w, y + rng.randint(-4, 5)],
                         [x + w, y + h], [x, y + h + rng.randint(-4, 5)]],
                        np.float64)
        m = np.zeros((size, size), np.float32)
        geo.fill_poly(m, poly, 1.0)
        pred[m > 0] = rng.uniform(0.45, 0.95)
        if rng.rand() < 0.5 and w > 30 and h > 16:
            hole = np.array([[x + 8, y + 5], [x + 16, y + 5],
                             [x + 16, y + 11], [x + 8, y + 11]], np.float64)
            hm = np.zeros((size, size), np.float32)
            geo.fill_poly(hm, hole, 1.0)
            pred[hm > 0] = 0.1
    return pred


POLY_SCENES = dict(SCENES, width100=width100)

# maps (N, H, W) with (thresh, box_thresh) for the representers; box_thresh
# above thresh, as DevicePolyRepresenter requires
POLY_CASES = {
    "boxes": lambda: (boxes_map()[None], 0.3, 0.5),
    "blobby": lambda: (np.stack([blobby_map(s) for s in range(6)]), 0.3,
                       0.5),
    "width100": lambda: (width100()[0][None], 0.3, 0.5),
    "rot_rect": lambda: (SCENES["rot_rect"]()[0][None], 0.3, 0.7),
    "speckles": lambda: (SCENES["speckles"]()[0][None], 0.25, 0.5),
    "nested_ring": lambda: (SCENES["nested_ring"]()[0][None], 0.3, 0.7),
    "low_score": lambda: (SCENES["low_score"]()[0][None], 0.3, 0.7),
}


# ------------------------------------------------------------ K7 and K8 ----

@pytest.mark.parametrize("scene", sorted(POLY_SCENES))
def test_device_poly_stats_match_jax(scene):
    """K7 through the plain versions: packed bitmap, bboxes and valid slots
    exact, hole-filled scores within the JAX f32 sums' error."""
    prob, thresh, _ = POLY_SCENES[scene]()
    ref = [np.asarray(a)[0] for a in jcc.device_poly_stats(
        jnp.asarray(prob)[None], thresh=thresh, max_components=K)]
    got = [t[0].numpy() for t in cc.device_poly_stats(
        _t(prob)[None], thresh=thresh, max_components=K)]
    for a, b, dtype in zip(got, ref, (np.uint8, np.int32, np.float32,
                                      np.bool_)):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[3], ref[3])
    assert np.abs(got[2] - ref[2]).max() <= score_tol(scene)
    assert ref[0].shape == (prob.shape[0], -(-prob.shape[1] // 8))


def test_device_poly_stats_batch_matches_per_image_calls():
    maps = [POLY_SCENES[s]()[0][:64, :64] for s in ("rot_rect", "nested_ring",
                                                   "speckles")]
    batched = cc.device_poly_stats(_t(np.stack(maps)), thresh=0.3)
    for i, m in enumerate(maps):
        for a, b in zip(batched, cc.device_poly_stats(_t(m)[None],
                                                      thresh=0.3)):
            assert torch.equal(a[i], b[0])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_component_boxes_match_jax(scene):
    """K8's per-slot boxes at its default K = 100: boxes, areas and valid
    exact, scores within the JAX f32 sums' error."""
    prob, thresh, _ = SCENES[scene]()
    labels = cc.connected_components(_t(prob > thresh)[None])
    ref = [np.asarray(a) for a in jcc.component_boxes(
        jnp.asarray(prob), jnp.asarray(labels[0].numpy()))]
    got = [t[0].numpy() for t in cc.component_boxes(_t(prob)[None], labels)]
    for i in (0, 2, 3):
        assert got[i].dtype == ref[i].dtype
        np.testing.assert_array_equal(got[i], ref[i])
    assert np.abs(got[1] - ref[1]).max() <= score_tol(scene)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_fast_boxes_match_jax(scene):
    prob, thresh, box_thresh = SCENES[scene]()
    ref = [np.asarray(a) for a in jcc.fast_boxes(
        jnp.asarray(prob), thresh=thresh, box_thresh=box_thresh)]
    got = [t[0].numpy() for t in cc.fast_boxes(
        _t(prob)[None], thresh=thresh, box_thresh=box_thresh)]
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[0], ref[0])
    assert np.abs(got[1] - ref[1]).max() <= score_tol(scene)


@pytest.mark.parametrize("width", [1, 7, 8, 9, 100, 640])
def test_pack_bits_matches_numpy(width):
    mask = np.random.RandomState(width).rand(3, 5, width) < 0.5
    got = cc.pack_bits(_t(mask))
    np.testing.assert_array_equal(got.numpy(), np.packbits(mask, axis=-1))


def _encoded_bbox_stats(keyed, prob, k):
    """The K7 stats kernel's scheme in plain torch: each group of 4
    neighbouring pixels takes its row and column from one division, then
    steps x and wraps to the next row (any W >= 1); the extremes are
    max-reduced as W - x, H - y, x + 1 and y + 1 into zeros (one memset)
    and decoded, so an empty slot gives [W, H, -1, -1] by itself."""
    n, h, w = prob.shape
    hw = h * w
    p0 = torch.arange(0, hw, 4)
    y, x = p0 // w, p0 % w
    xs, ys = [], []
    for _ in range(4):
        xs.append(x)
        ys.append(y)
        x = x + 1
        wrap = x == w
        x, y = torch.where(wrap, 0, x), torch.where(wrap, y + 1, y)
    xs = torch.stack(xs, 1).reshape(-1)[:hw].expand(n, -1)
    ys = torch.stack(ys, 1).reshape(-1)[:hw].expand(n, -1)
    key = keyed.reshape(n, -1).long()

    def reduce(values, how):
        out = torch.zeros((n, k + 1), dtype=values.dtype)
        if how == "sum":
            out.scatter_add_(1, key, values)
        else:
            out.scatter_reduce_(1, key, values, "amax")
        return out[:, :k]

    cnt = reduce(torch.ones_like(key), "sum")
    psum = reduce(prob.reshape(n, -1).double(), "sum")
    ext = [reduce(v, "max") for v in (w - xs, h - ys, xs + 1, ys + 1)]
    bbox = torch.stack([w - ext[0], h - ext[1], ext[2] - 1, ext[3] - 1], -1)
    return cnt.to(torch.int32), psum, bbox.to(torch.int32)


def _k7_case(case):
    """(mask, prob) of one image: a scene at its threshold, a K3 sweep mask
    at a ragged size (one row, one column, one pixel) with prob from a
    seed, or noise with more components than K."""
    kind, name, *size = case.split(":")
    if kind == "scene":
        prob, thresh, _ = POLY_SCENES[name]()
        return prob > thresh, prob
    h, w = map(int, size[0].split("x"))
    prob = np.random.RandomState(4).rand(h, w).astype(np.float32)
    if kind == "noise":
        return prob > 0.5, prob
    return k3_sweep_mask(name, h, w), prob


K7_CASES = ([f"scene:{s}" for s in sorted(POLY_SCENES)]
            + [f"sweep:{m}:{s}" for m in K3_SWEEP
               for s in ("37x53", "1x40", "50x1", "1x1")]
            + ["noise::96x128"])


@pytest.mark.parametrize("case", K7_CASES)
def test_encoded_extremes_give_the_plain_stats(case):
    """The identity the K7 stats kernel rests on: zero-filled max
    reductions of W - x, H - y, x + 1 and y + 1, decoded, equal
    ``bbox_stats_plain`` bit for bit, with K of 1, 10 and 1000 (components
    beyond K in slot K, dropped), on all-foreground and all-background
    maps, and at widths below a group of 4 pixels."""
    mask, prob = _k7_case(case)
    labels = cc.connected_components_plain(_t(mask)[None])
    for k in (1, 10, 1000):
        keyed, _ = cc.compact_slots_plain(labels, k)
        got = _encoded_bbox_stats(keyed, _t(prob)[None], k)
        ref = cc.bbox_stats_plain(keyed, _t(prob)[None], k)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("scene", sorted(POLY_SCENES))
def test_poly_stats_plain_matches_jax(scene):
    """The plain version of the K7 stats with the polygon epilogue, on the
    plain K3, K4 and K6, against the JAX ``_device_poly_stats_single``:
    bboxes and valid exact, scores within the JAX f32 sums' error."""
    prob, thresh, _ = POLY_SCENES[scene]()
    ref = [np.asarray(a) for a in jcc._device_poly_stats_single(
        jnp.asarray(prob), jnp.float32(thresh), max_components=K)]
    p = _t(prob)[None]
    mask = p > thresh
    keyed, valid_root = cc.compact_slots_plain(
        cc.connected_components_plain(mask), K)
    bg_keyed, _ = cc.compact_slots_plain(
        cc.connected_components_plain(~mask, 4), K)
    hole = cc.hole_stats_plain(mask, keyed, bg_keyed, p, K)
    bboxes, scores, valid = (t[0].numpy() for t in cc.poly_stats(
        keyed, valid_root, p, *hole, K))
    assert (bboxes.dtype, scores.dtype, valid.dtype) == (
        np.int32, np.float32, np.bool_)
    np.testing.assert_array_equal(bboxes, ref[1])
    np.testing.assert_array_equal(valid, ref[3])
    assert np.abs(scores - ref[2]).max() <= score_tol(scene)


def _gather8(lo, hi):
    """Bits 56..63 of (lo | hi << 32) * 0x8040201008040201 mod 2**64, in
    int64 without overflow: the 32-bit halves' products, carried."""
    cl, ch = 0x08040201, 0x80402010
    t = (lo * ch + hi * cl) & 0xFFFFFFFF
    return ((((lo * cl) >> 32) + t) >> 24) & 0xFF


def _pack_by_words(mask):
    """The K7 bit-pack kernel in plain torch. W % 8 == 0: the batch as one
    byte stream, 16 bytes a thread (the last may hold 8), each byte set to
    0 or 1 (``__vsetne4``), each 8 gathered into a byte by the 64-bit
    multiply. Other widths: a byte from 8 pixels of a row, MSB first."""
    n, h, w = mask.shape
    w8 = -(-w // 8)
    if w % 8:
        bits = torch.zeros((n, h, w8 * 8), dtype=torch.long)
        bits[..., :w] = (mask != 0).long()
        return (bits.view(n, h, w8, 8)
                << torch.arange(7, -1, -1)).sum(-1).to(torch.uint8)
    flat = mask.reshape(-1).long()
    total = flat.numel()
    flat = torch.cat([flat, flat.new_zeros(-total % 16)])
    ones = (flat != 0).long().view(-1, 2, 4)
    words = (ones << torch.arange(0, 32, 8)).sum(-1)    # little-endian
    packed = _gather8(words[:, 0], words[:, 1])
    return packed[:total // 8].to(torch.uint8).view(n, h, w8)


@pytest.mark.parametrize("width", [1, 7, 8, 9, 16, 100, 640, 641])
def test_pack_by_words_matches_numpy(width):
    """The bit-pack kernel's scheme against ``np.packbits`` of
    ``mask != 0``, on bool masks and on uint8 masks holding 0, 1, 2 and
    255, with a row count that leaves the word path's last thread 8
    bytes where W = 8."""
    rng = np.random.RandomState(width)
    for mask in (rng.rand(3, 5, width) < 0.5,
                 rng.choice(np.array([0, 1, 2, 255], np.uint8),
                            (3, 5, width))):
        got = _pack_by_words(_t(mask).view(torch.uint8))
        np.testing.assert_array_equal(got.numpy(),
                                      np.packbits(mask != 0, axis=-1))


def test_bbox_stats_fill_values_and_types():
    """Empty slots keep the JAX fill: count 0, sum 0, bbox [W, H, -1, -1];
    an empty slot before a full one; pixels of slot K are dropped."""
    keyed = torch.full((1, 3 * 5), 4, dtype=torch.int32)
    keyed[0, [6, 7, 13]] = 1
    prob = torch.linspace(0, 1, 15).reshape(1, 3, 5)
    cnt, psum, bbox = cc.bbox_stats(keyed, prob, 4)
    assert (cnt.dtype, psum.dtype, bbox.dtype) == (torch.int32, torch.float64,
                                                   torch.int32)
    assert cnt.tolist() == [[0, 3, 0, 0]]
    assert bbox.tolist() == [[[5, 3, -1, -1], [1, 1, 3, 2], [5, 3, -1, -1],
                              [5, 3, -1, -1]]]
    assert psum[0, 1].item() == prob.view(-1)[[6, 7, 13]].double().sum()
    assert psum[0, [0, 2, 3]].tolist() == [0.0, 0.0, 0.0]


def test_cpu_wrappers_count_no_launch():
    cc.reset_launches()
    prob, thresh, _ = SCENES["rot_rect"]()
    cc.device_poly_stats(_t(prob)[None], thresh=thresh)
    cc.fast_boxes(_t(prob)[None], thresh=thresh)
    assert all(v == 0 for v in cc.LAUNCHES.values())


# ----------------------------------------------------------- representers --

@pytest.mark.parametrize("case", sorted(POLY_CASES))
def test_host_polygons_match_jax(case):
    maps, thresh, box_thresh = POLY_CASES[case]()
    batch = {"shape": [(2 * m.shape[0], 3 * m.shape[1] // 2) for m in maps]}
    ref_b, ref_s = jpost.SegDetectorRepresenter(thresh, box_thresh)(
        batch, maps[..., None], is_output_polygon=True)
    got_b, got_s = tpost.SegDetectorRepresenter(thresh, box_thresh)(
        batch, maps[..., None], is_output_polygon=True)
    for gb, rb, gs, rs in zip(got_b, ref_b, got_s, ref_s):
        assert len(gb) == len(rb)
        for a, b in zip(gb, rb):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
        assert gs == rs


@pytest.mark.parametrize("case", sorted(POLY_CASES))
def test_device_poly_representer_matches_jax(case):
    maps, thresh, box_thresh = POLY_CASES[case]()
    batch = {"shape": [(2 * m.shape[0], 3 * m.shape[1] // 2) for m in maps]}
    ref_b, ref_s = jpost.DevicePolyRepresenter(thresh, box_thresh)(
        batch, jnp.asarray(maps), is_output_polygon=True)
    got_b, got_s = tpost.DevicePolyRepresenter(thresh, box_thresh)(
        batch, _t(maps))
    for gb, rb, gs, rs in zip(got_b, ref_b, got_s, ref_s):
        assert len(gb) == len(rb)
        for a, b in zip(gb, rb):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(gs, rs, rtol=0, atol=2e-4)


@pytest.mark.parametrize("case", sorted(POLY_CASES))
def test_device_poly_matches_host_polygon_mode(case):
    """The port's device-assisted path against its own host path: the same
    polygons, scores within 2e-3 (holes filled on both; the nested ring's
    outer component is rejected on both paths)."""
    maps, thresh, box_thresh = POLY_CASES[case]()
    batch = {"shape": [m.shape for m in maps]}
    hb, hs = tpost.SegDetectorRepresenter(thresh, box_thresh)(
        batch, maps[..., None], is_output_polygon=True)
    db, ds = tpost.DevicePolyRepresenter(thresh, box_thresh)(
        batch, _t(maps)[..., None])
    for i in range(len(maps)):
        assert len(hb[i]) == len(db[i]), f"image {i}"
        for a, b in zip(hb[i], db[i]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(hs[i], ds[i], rtol=0, atol=POLY_TOL)
    if case in ("boxes", "blobby", "width100"):
        assert sum(len(b) for b in db) >= 2


def test_device_poly_rescales_to_dest():
    batch = {"shape": [(320, 480)]}
    boxes, _ = tpost.DevicePolyRepresenter(0.3, 0.5)(batch,
                                                     _t(boxes_map())[None])
    assert len(boxes[0]) == 2
    for b in boxes[0]:
        assert b[:, 0].max() <= 480 and b[:, 1].max() <= 320
        assert b[:, 0].max() > 160


def test_device_poly_representer_contract():
    """box_thresh <= thresh is refused (hole borders would pass the gate on
    the host), rect mode belongs to DeviceBoxRepresenter, and an empty map
    gives no polygon."""
    with pytest.raises(ValueError, match="box_thresh > thresh"):
        tpost.DevicePolyRepresenter(thresh=0.3, box_thresh=0.3)
    rep = tpost.DevicePolyRepresenter()
    with pytest.raises(ValueError, match="DeviceBoxRepresenter"):
        rep({"shape": [(8, 8)]}, torch.zeros((1, 8, 8)),
            is_output_polygon=False)
    assert rep({"shape": [(8, 8)]}, torch.zeros((1, 8, 8, 2))) == ([[]],
                                                                   [[]])


def test_colliding_bboxes_pair_scores_in_jax_order():
    """Two valid slots with one pixel bbox keep both scores, and a contour
    of that bbox takes the last one left, as in the JAX package. The host
    half is fed the device outputs directly (one drawn component, a second
    slot sharing its bbox), against the JAX ``_finish`` on the lookup table
    its ``__call__`` builds from the same outputs."""
    bitmap = np.zeros((40, 48), np.uint8)
    bitmap[10:25, 6:40] = 1
    bbox = [6, 10, 39, 24]
    bboxes = np.array([[bbox, bbox, [0, 0, 3, 3], [48, 40, -1, -1]]],
                      np.int32)
    scores = np.array([[0.9, 0.8, 0.95, 0.0]], np.float32)
    valid = np.array([[True, True, True, False]])
    rep = tpost.DevicePolyRepresenter(0.3, 0.5)
    got = rep.finish({"shape": [(40, 48)]}, 48,
                     np.packbits(bitmap, axis=-1)[None], bboxes, scores,
                     valid)
    lut = {tuple(bbox): [float(np.float32(0.9)), float(np.float32(0.8))],
           (0, 0, 3, 3): [float(np.float32(0.95))]}
    ref = jpost.DevicePolyRepresenter(0.3, 0.5)._finish(bitmap, lut, 48, 40,
                                                        48, 40)
    assert len(got[0][0]) == len(ref[0]) == 1
    np.testing.assert_array_equal(got[0][0][0], ref[0][0])
    assert got[1][0] == ref[1] == [float(np.float32(0.8))]


def test_hole_filled_device_score_matches_box_score_fast():
    pred = np.full((96, 96), 0.05, np.float32)
    m = np.zeros((96, 96), np.float32)
    geo.fill_poly(m, np.array([[10, 10], [80, 12], [78, 50], [12, 48]],
                              np.float64), 1.0)
    pred[m > 0] = 0.7
    hm = np.zeros((96, 96), np.float32)
    geo.fill_poly(hm, np.array([[30, 20], [50, 20], [50, 35], [30, 35]],
                               np.float64), 1.0)
    pred[hm > 0] = 0.08
    _, _, scores, valid = cc.device_poly_stats(_t(pred)[None], thresh=0.3)
    dev_score = float(scores[0][valid[0]][0])
    contour = geo.find_contours((pred > 0.3).astype(np.uint8))[0]
    host_score = tpost.SegDetectorRepresenter(0.3, 0.5).box_score_fast(
        pred, np.asarray(contour, np.float64))
    assert abs(dev_score - host_score) < POLY_TOL and dev_score < 0.65


def test_hole_sealed_by_diagonal_strokes_counts_toward_device_score():
    """The 4-connected background pass (K6) keeps a hole sealed only by
    diagonal steps, as the host's filled contour does; the JAX value too."""
    pred, thresh, box_thresh = SCENES["diagonal_hole"]()
    _, _, scores, valid = cc.device_poly_stats(_t(pred)[None], thresh=thresh)
    vals = scores[0][valid[0]].numpy()
    _, _, jscores, jvalid = jcc.device_poly_stats(jnp.asarray(pred)[None],
                                                  thresh=thresh)
    np.testing.assert_allclose(vals, np.asarray(jscores)[0][
        np.asarray(jvalid)[0]], rtol=0, atol=1e-5)
    contour = geo.find_contours((pred > thresh).astype(np.uint8))[0]
    host = tpost.SegDetectorRepresenter(thresh, box_thresh).box_score_fast(
        pred, np.asarray(contour, np.float64))
    assert len(vals) == 1 and host < 0.5 and abs(vals[0] - host) < 2e-2


@pytest.mark.parametrize("seed", range(4))
def test_approx_poly_dp_matches_jax(seed):
    rng = np.random.RandomState(seed)
    contour = geo.find_contours((blobby_map(seed) > 0.3).astype(np.uint8))
    for c in contour[:5]:
        c = np.asarray(c, np.float64)
        eps = rng.choice([0.0, 0.5, 0.005 * geo.polygon_perimeter(c), 4.0])
        np.testing.assert_array_equal(geo.approx_poly_dp(c, eps),
                                      jgeo.approx_poly_dp(c, eps))


# ------------------------------------------------------------------ DetEval --

def _sq(x, y, w, h):
    return [(x, y), (x + w, y), (x + w, y + h), (x, y + h)]


def _quad(rng, cx, cy, w, h, deg):
    th = np.deg2rad(deg)
    c, s = np.cos(th), np.sin(th)
    corners = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
    return [tuple(p) for p in np.round(corners @ [[c, s], [-s, c]]
                                       + [cx, cy], 1).tolist()]


def _random_image(rng):
    """GT words and detections that hit, split, merge, miss and overlap
    ignored words."""
    gts, preds = [], []
    for _ in range(rng.randint(1, 7)):
        cx, cy = rng.uniform(40, 260, 2)
        w, h, deg = rng.uniform(20, 80), rng.uniform(8, 24), rng.uniform(-30,
                                                                          30)
        gts.append({"points": _quad(rng, cx, cy, w, h, deg),
                    "ignore": bool(rng.rand() < 0.15)})
        kind = rng.randint(4)
        if kind == 0:       # a hit, jittered
            preds.append({"points": _quad(rng, cx + rng.normal(0, 2),
                                          cy + rng.normal(0, 2),
                                          w * rng.uniform(0.85, 1.15), h,
                                          deg + rng.normal(0, 3)),
                          "ignore": False})
        elif kind == 1:     # split into two halves
            for side in (-1, 1):
                preds.append({"points": _quad(
                    rng, cx + side * w / 4 * np.cos(np.deg2rad(deg)),
                    cy + side * w / 4 * np.sin(np.deg2rad(deg)), w / 2, h,
                    deg), "ignore": False})
        elif kind == 2:     # a false positive elsewhere
            preds.append({"points": _quad(rng, *rng.uniform(0, 300, 2), 30,
                                          10, 0), "ignore": False})
    if len(gts) >= 2 and rng.rand() < 0.5:    # one detection over two words
        a, b = (np.asarray(g["points"]) for g in gts[:2])
        pts = np.concatenate([a, b])
        x0, y0 = pts.min(0)
        x1, y1 = pts.max(0)
        preds.append({"points": _sq(x0, y0, x1 - x0, y1 - y0),
                      "ignore": False})
    return gts, preds


DETEVAL_CASES = {
    "one_to_one": ([_sq(0, 0, 10, 10)], [_sq(0.5, 0.5, 10, 10)]),
    "split": ([_sq(0, 0, 20, 10)], [_sq(0, 0, 10, 10), _sq(10, 0, 10, 10)]),
    "merge": ([_sq(0, 0, 10, 10), _sq(12, 0, 10, 10)], [_sq(0, 0, 22, 10)]),
    "miss": ([_sq(0, 0, 10, 10)], []),
    "no_gt": ([], [_sq(0, 0, 10, 10)]),
}


def _same_results(got, ref):
    """Per-image DetEval results equal; with no detection the JAX version
    leaves its 1x1 overlap matrices uninitialised (np.empty), the port's
    are zeros, so those are compared only where there are detections."""
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        skip = () if a["detPolPoints"] else ("recallMat", "precisionMat")
        assert {k: v for k, v in a.items() if k not in skip} == \
            {k: v for k, v in b.items() if k not in skip}
        assert set(a) == set(b)


@pytest.mark.parametrize("case", sorted(DETEVAL_CASES))
def test_deteval_cases_match_jax(case):
    gts, preds = DETEVAL_CASES[case]
    gts = [{"points": g, "ignore": False} for g in gts]
    preds = [{"points": p, "ignore": False} for p in preds]
    ref = JaxDetEval().evaluate_image(gts, preds)
    got = DetectionDetEvalEvaluator().evaluate_image(gts, preds)
    _same_results([got], [ref])
    full = [{"points": _sq(0, 0, 10, 10), "ignore": False}]
    results = [got, DetectionDetEvalEvaluator().evaluate_image(full, full)]
    assert DetectionDetEvalEvaluator().combine_results(results) == \
        JaxDetEval().combine_results(results)


@pytest.mark.parametrize("seed", range(6))
def test_deteval_random_images_match_jax(seed):
    rng = np.random.RandomState(seed)
    images = [_random_image(rng) for _ in range(4)]
    kw = {"area_recall_constraint": 0.7, "area_precision_constraint": 0.5} \
        if seed % 2 else {}
    ref_ev, ev = JaxDetEval(**kw), DetectionDetEvalEvaluator(**kw)
    ref = [ref_ev.evaluate_image(g, p) for g, p in images]
    got = [ev.evaluate_image(g, p) for g, p in images]
    _same_results(got, ref)
    assert ev.combine_results(got) == ref_ev.combine_results(ref)
    assert any(r["pairs"] for r in got)


# ---------------------------------------------------------------- the CLIs --

@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    v = jax.device_get(JaxDBTextModel().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    path = str(tmp_path_factory.mktemp("model") / "dbnet.pth")
    torch.save(state_dict_from_jax(v["params"], v["batch_stats"]), path)
    return path


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    """Two seeded 64x640 PNGs (640 wide, so the inference resize keeps
    them) with TotalText GT files, one word of each ignored."""
    import cv2

    root = tmp_path_factory.mktemp("eval")
    os.makedirs(root / "imgs")
    os.makedirs(root / "gts")
    rng = np.random.RandomState(5)
    for i in (1, 2):
        img = (rng.rand(64, 640, 3) * 60).astype(np.uint8)
        img[10:40, 30 + 100 * i:250 + 100 * i] = 220
        cv2.imwrite(str(root / "imgs" / f"img{i}.png"), img)
        with open(root / "gts" / f"gt_img{i}.txt", "w") as f:
            f.write(f"{30 + 100 * i},10,{250 + 100 * i},10,{250 + 100 * i},"
                    f"40,{30 + 100 * i},40,word\n")
            f.write("5,45,60,45,60,60,5,60,#\n")
    return root


def _eval_argv(root, out, batch_size):
    return ["--image_dir", str(root / "imgs"), "--model_path", "MODEL",
            "--gt_dir", str(root / "gts"), "--dataset", "totaltext",
            "--preds_fp", str(out / "preds.pkl"),
            "--img_fns_fp", str(out / "fns.pkl"),
            "--gts_fp", str(out / "gts.pkl"), "--batch_size", str(batch_size)]


def _load(out):
    return [pickle.load(open(out / name, "rb"))
            for name in ("preds.pkl", "fns.pkl", "gts.pkl")]


def _assert_pred_structure(preds, n):
    assert isinstance(preds, list) and len(preds) == n
    for image in preds:
        assert isinstance(image, list)
        for rec in image:
            assert set(rec) == {"points", "text", "ignore"}
            assert rec["text"] == "text_sample" and rec["ignore"] is False
            assert all(isinstance(p, tuple) and len(p) == 2
                       and all(isinstance(v, int) for v in p)
                       for p in rec["points"])


def test_make_eval_writes_the_jax_pickles(pth, eval_dir, tmp_path):
    """Single and batched paths on the CPU: prediction pickles in the JAX
    structure, image names and the GT pickle equal to the JAX exporter's."""
    ref_out, out, out_b = (tmp_path / d for d in ("jax", "port", "batched"))
    for d in (ref_out, out, out_b):
        os.makedirs(d)
    argv = [a.replace("MODEL", pth) for a in _eval_argv(eval_dir, ref_out, 1)]
    jmake_eval.main(jmake_eval.load_args(argv))
    for o, bs in ((out, 1), (out_b, 2)):
        argv = [a.replace("MODEL", pth) for a in _eval_argv(eval_dir, o, bs)]
        make_eval.main(make_eval.load_args(argv + ["--device", "cpu"]))
    ref_preds, ref_fns, ref_gts = _load(ref_out)
    for o in (out, out_b):
        preds, fns, gts = _load(o)
        _assert_pred_structure(preds, 2)
        assert fns == ref_fns == ["img1.png", "img2.png"]
        assert gts == ref_gts
        assert [g["ignore"] for g in gts[0]] == [False, True]
    _assert_pred_structure(ref_preds, 2)


@pytest.mark.parametrize("mode", ["folded", "int8"])
def test_make_eval_runs_the_folded_forwards(mode, pth, eval_dir, tmp_path):
    """``--infer_mode folded|int8`` reaches the BN-folded prob-only
    forward: the same pickles' structure, image names and GTs as the JAX
    exporter writes, in the single and batched paths."""
    ref_out = tmp_path / "jax"
    os.makedirs(ref_out)
    argv = [a.replace("MODEL", pth) for a in _eval_argv(eval_dir, ref_out, 1)]
    jmake_eval.main(jmake_eval.load_args(argv))
    _, ref_fns, ref_gts = _load(ref_out)
    for bs in (1, 2):
        out = tmp_path / f"port{bs}"
        os.makedirs(out)
        argv = [a.replace("MODEL", pth) for a in _eval_argv(eval_dir, out, bs)]
        make_eval.main(make_eval.load_args(
            argv + ["--device", "cpu", "--infer_mode", mode]))
        preds, fns, gts = _load(out)
        _assert_pred_structure(preds, 2)
        assert fns == ref_fns and gts == ref_gts


def test_make_eval_representer_choice():
    """DeviceBoxRepresenter only in rect mode with device boxes, as in the
    JAX make_eval; polygon mode takes the host representer."""
    base = ["--image_dir", "x"]
    for extra, cls in (([], tpost.SegDetectorRepresenter),
                       (["--is_output_polygon", "false"],
                        tpost.DeviceBoxRepresenter),
                       (["--is_output_polygon", "false", "--device_boxes",
                         "false"], tpost.SegDetectorRepresenter)):
        assert make_eval.choose_representer(
            make_eval.load_args(base + extra)).__class__ is cls


@pytest.mark.parametrize("cli", ["deteval", "ioueval"])
def test_eval_clis_match_jax(cli, tmp_path):
    rng = np.random.RandomState(11)
    images = [_random_image(rng) for _ in range(5)]
    gts_fp, preds_fp = tmp_path / "gts.pkl", tmp_path / "preds.pkl"
    pickle.dump([g for g, _ in images], open(gts_fp, "wb"))
    pickle.dump([p for _, p in images], open(preds_fp, "wb"))
    argv = ["--poly_gts_fp", str(gts_fp), "--poly_preds_fp", str(preds_fp)]
    ref_mod, mod = {"deteval": (jdeteval_cli, deteval_cli),
                    "ioueval": (jioueval_cli, ioueval_cli)}[cli]
    for extra in ([], ["--tp", "0.5", "--tr", "0.7"] if cli == "deteval"
                  else ["--iou", "0.4", "--area", "0.8"]):
        ref = ref_mod.main(ref_mod.load_args(argv + extra))
        assert mod.main(mod.load_args(argv + extra)) == ref
        assert 0.0 < ref["hmean"] < 1.0


# ---------------------------------------------------------- quality bench --

def test_ctw_polygon_operating_point_warning(capsys):
    base = ["--data_dir", "/nonexistent", "--out", "/tmp/x.json",
            "--dataset_format", "ctw1500", "--polygon"]
    assert qb.warn_ctw_polygon_operating_point(qb.load_args(base)) is True
    assert "unclip_ratio 2.5" in capsys.readouterr().err
    assert qb.warn_ctw_polygon_operating_point(
        qb.load_args(base + ["--unclip_ratio", "2.5"])) is False
    assert qb.warn_ctw_polygon_operating_point(qb.load_args(
        ["--data_dir", "/n", "--out", "/tmp/x.json"])) is False


def test_line_level_preset_sets_polygon_and_unclip():
    base = ["--data_dir", "/n", "--out", "/tmp/x.json",
            "--dataset_format", "ctw1500"]
    a = qb.load_args(base + ["--line_level"])
    assert a.polygon is True and a.unclip_ratio == 2.5
    a = qb.load_args(base + ["--line_level", "--unclip_ratio", "3.0"])
    assert a.unclip_ratio == 3.0
    a = qb.load_args(base)
    assert a.polygon is False and a.unclip_ratio == 1.5


def test_full_eval_on_a_cpu_trainer_gives_all_four_rows(tmp_path):
    """The quality bench's eval on a CPU trainer with seeded weights: the
    four rows under both protocols, P/R/F in [0, 1], and the host and
    device polygon rows agree (the device path's purpose)."""
    from db_text_minimal_tpu_torch.data.scenes import text_batch
    from db_text_minimal_tpu_torch.train.trainer import Trainer

    args = qb.load_args(["--data_dir", str(tmp_path), "--out", "x.json",
                         "--img_size", "64", "--polygon", "--device", "cpu"])
    cfg = qb.build_cfg(args)
    cfg.logging.logger_file = None
    assert cfg.meta.device == "cpu" and cfg.metric.thred_text_score == 0.25
    trainer = Trainer(cfg)
    state = trainer.init_state()
    loader = [text_batch(40 + i, 2, 64) for i in range(2)]
    out = qb.full_eval(trainer, state, loader, args)
    assert out["n_test_images"] == 4
    for row in ("host", "device", "host_poly", "device_poly"):
        for proto in ("iou_pascal", "deteval"):
            assert set(out[row][proto]) == {"precision", "recall", "hmean"}
            assert all(0.0 <= v <= 1.0 for v in out[row][proto].values())
        assert out[row]["postprocess_wall_s"] >= 0.0
    assert out["host_poly"]["deteval"] == out["device_poly"]["deteval"]


def test_quality_bench_main_names_the_missing_datasets():
    args = qb.load_args(["--data_dir", "/n", "--out", "/tmp/x.json"])
    with pytest.raises(NotImplementedError, match="Still open' item 1"):
        qb.main(args)
