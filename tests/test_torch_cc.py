"""The PyTorch port's device rect postprocess kernels K3-K6
(``db_text_minimal_tpu_torch/ops/cc.py``) against the JAX ``cc.py``.

On CPU tensors each wrapper runs its plain PyTorch version, which repeats the
CUDA kernel's arithmetic; ``test_torch_cuda.py`` holds the kernels to these
versions on the card. Labels and slots must be exactly equal. Float sums:
the JAX version sums in f32 by scatter, the port exactly (int64 coordinates)
or in f64 (prob and second moments), so a JAX sum of n terms may be off by
up to about n·2⁻²⁴ of its value; the tolerances (``torch_scenes``) follow
from that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu.ops.pallas import cc as jcc
from db_text_minimal_tpu_torch.ops import cc
from torch_scenes import (K3_SWEEP, SCENES, corner_tol, k3_sweep_mask,
                          score_tol)

torch.set_num_threads(1)

K = 1000
EPS32 = 2.0 ** -24


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))[None]


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_labels_and_slots_match_jax(scene):
    """K3 (8-connected foreground, 4-connected background) and K4."""
    prob, thresh, _ = SCENES[scene]()
    mask = prob > thresh
    for m, conn in ((mask, 8), (~mask, 4)):
        ref = np.asarray(jcc.connected_components(
            jnp.asarray(m, jnp.int32), connectivity=conn))
        got = cc.connected_components(_t(m), conn)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), ref)
        key_ref, valid_ref = jcc._compact_slots(jnp.asarray(ref.reshape(-1)),
                                                K)
        keyed, valid_root = cc.compact_slots(got, K)
        np.testing.assert_array_equal(keyed[0].numpy(), np.asarray(key_ref))
        np.testing.assert_array_equal(valid_root[0].numpy(),
                                      np.asarray(valid_ref))


@pytest.mark.parametrize("shape,density", [((37, 53), 0.45), ((64, 33), 0.6),
                                           ((1, 40), 0.5), ((50, 1), 0.7)])
def test_random_masks_match_jax(shape, density):
    """Noise masks of odd shapes (many merges, ragged tiles), both
    connectivities, against the JAX labelling run to convergence."""
    mask = np.random.RandomState(7).rand(*shape) < density
    for m, conn in ((mask, 8), (~mask, 4)):
        ref = np.asarray(jcc.connected_components(
            jnp.asarray(m, jnp.int32), num_iters=4096, connectivity=conn))
        got = cc.connected_components(_t(m), conn)[0].numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("name", K3_SWEEP)
def test_plain_labels_match_jax_on_the_kernel_sweep(name, connectivity):
    """K3's plain version, the yardstick the CUDA kernel is held to on the
    card, against the JAX labelling run to convergence on the same hard
    masks (full, empty, checkerboard, diagonals through tile corners,
    serpentines, noise near the percolation thresholds), exact."""
    mask = k3_sweep_mask(name, 70, 97)
    ref = np.asarray(jcc.connected_components(
        jnp.asarray(mask, jnp.int32), num_iters=4096,
        connectivity=connectivity))
    got = cc.connected_components_plain(_t(mask), connectivity)
    np.testing.assert_array_equal(got[0].numpy(), ref)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_hole_stats_match_jax(scene):
    """K6: hole counts exact, hole sums within the JAX f32 sum's error."""
    prob, thresh, _ = SCENES[scene]()
    mask = prob > thresh
    h, w = prob.shape
    keyed, _ = cc.compact_slots(cc.connected_components(_t(mask)), K)
    bg_keyed, _ = cc.compact_slots(cc.connected_components(_t(~mask), 4), K)
    sum_ref, cnt_ref = map(np.asarray, jcc._hole_stats(
        jnp.asarray(mask, jnp.int32), jnp.asarray(keyed[0].numpy()),
        jnp.asarray(prob.reshape(-1)), h, w, K))
    hole_sum, hole_cnt = cc.hole_stats(_t(mask), keyed, bg_keyed, _t(prob), K)
    np.testing.assert_array_equal(hole_cnt[0].numpy(), cnt_ref)
    tol = 1e-6 + cnt_ref * EPS32 * np.abs(sum_ref)
    assert np.all(np.abs(hole_sum[0].numpy() - sum_ref) <= tol)


# K4's masks: noise of ragged shapes (a row, a column, a pixel), all
# background, all foreground, and sparse noise with more components than
# K = 1000 under either connectivity
K4_MASKS = {"noise_37x53": ((37, 53), 0.25), "noise_1x40": ((1, 40), 0.25),
            "noise_50x1": ((50, 1), 0.25), "noise_1x1": ((1, 1), 0.5),
            "sparse_160x160": ((160, 160), 0.12),
            "zeros_37x53": ((37, 53), 0.0), "ones_37x53": ((37, 53), 1.0)}


def _k4_mask(name):
    shape, density = K4_MASKS[name]
    return np.random.RandomState(3).rand(*shape) < density


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("k", [1, 10, 1000])
@pytest.mark.parametrize("name", sorted(K4_MASKS))
def test_compact_slots_match_jax(name, k, connectivity):
    """K4 against the JAX ``_compact_slots`` on the same labels, exact:
    overflow components and background in slot K, valid_root the first
    min(roots, K) slots."""
    labels = cc.connected_components_plain(_t(_k4_mask(name)), connectivity)
    roots = int((labels.reshape(-1) == torch.arange(labels.numel())).sum())
    if name == "sparse_160x160":
        assert roots > 1000
    key_ref, valid_ref = jcc._compact_slots(
        jnp.asarray(labels[0].numpy().reshape(-1)), k)
    keyed, valid_root = cc.compact_slots(labels, k)
    assert keyed.dtype == torch.int32 and valid_root.dtype == torch.bool
    np.testing.assert_array_equal(keyed[0].numpy(), np.asarray(key_ref))
    np.testing.assert_array_equal(valid_root[0].numpy(),
                                  np.asarray(valid_ref))
    assert int(valid_root.sum()) == min(roots, k)


def _ranked_in_place(labels, k, tile):
    """The K4 kernel's scheme in plain torch: per-tile root counts, their
    exclusive scan (what the look-back gives each tile), each root's rank
    as the tile's prefix plus the roots before it in the tile, written
    clamped into the slot map at the root itself over values never
    initialised, then every pixel's slot read through its label."""
    n, hw = labels.shape
    flat = labels.long()
    ntiles = max(1, -(-hw // tile))
    is_root = torch.zeros((n, ntiles * tile), dtype=torch.long)
    is_root[:, :hw] = flat == torch.arange(hw)
    by_tile = is_root.view(n, ntiles, tile)
    counts = by_tile.sum(2)
    prefix = torch.cumsum(counts, 1) - counts
    rank = (prefix[..., None] + torch.cumsum(by_tile, 2) - by_tile)
    rank = rank.reshape(n, -1)[:, :hw]
    roots = is_root[:, :hw].bool()
    keyed = torch.full((n, hw), -7)         # what torch.empty might hold
    keyed[roots] = rank[roots].clamp(max=k)
    fg = flat >= 0
    # the gather reads roots only, so no pixel reads a slot being written
    assert bool(roots.gather(1, flat.clamp(min=0))[fg].all())
    keyed = torch.where(fg, keyed.gather(1, flat.clamp(min=0)), k)
    total = prefix[:, -1] + counts[:, -1]
    return (keyed.to(torch.int32),
            torch.arange(k)[None] < total[:, None])


@pytest.mark.parametrize("tile", [7, 128, 4096, 16384])
@pytest.mark.parametrize("name", sorted(K4_MASKS))
def test_ranked_in_place_gives_the_plain_slots(name, tile):
    """The identity the K4 kernel rests on: ranks written in place at the
    roots and read through the labels equal ``compact_slots_plain``, bit
    for bit, with tiles that do not divide H·W, both connectivities, K of
    1, 10 and 1000."""
    mask = _k4_mask(name)
    for connectivity in (8, 4):
        labels = cc.connected_components_plain(_t(mask), connectivity)
        labels = labels.reshape(1, -1)
        for k in (1, 10, 1000):
            got = _ranked_in_place(labels, k, tile)
            ref = cc.compact_slots_plain(labels, k)
            assert torch.equal(got[0], ref[0])
            assert torch.equal(got[1], ref[1])


def _route_by_table(mask, fg_keyed, bg_keyed, prob, k):
    """The K6 kernels' route in plain torch: the 8-neighbour min from the
    column minima of a 1-pixel halo (the min over three columns of the
    rows above and below, the two side columns of the pixel's own row),
    a per-bg-slot table {border touched, K - enclosing} filled with 0 (a
    memset), and each bg pixel's target read from it."""
    n, h, w = mask.shape
    padded = torch.full((n, h + 2, w + 2), k, dtype=torch.long)
    padded[:, 1:-1, 1:-1] = fg_keyed.reshape(n, h, w)
    side = torch.minimum(padded[:, :, :-2], padded[:, :, 2:])
    m3 = torch.minimum(side, padded[:, :, 1:-1])
    nb = torch.minimum(torch.minimum(m3[:, :-2], m3[:, 2:]), side[:, 1:-1])
    key = bg_keyed.reshape(n, -1).long()
    bg = ~mask.reshape(n, -1).bool()
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    edge = ((ys == 0) | (xs == 0) | (ys == h - 1) | (xs == w - 1))
    edge = edge.reshape(1, -1).expand(n, -1).long()
    border = torch.zeros((n, k + 1), dtype=torch.long)
    border.scatter_reduce_(1, key, edge, "amax")
    inverse = torch.zeros((n, k + 1), dtype=torch.long)
    inverse.scatter_reduce_(1, key, torch.where(bg, k - nb.reshape(n, -1), 0),
                            "amax")
    target = torch.where((inverse > 0) & (border == 0), k - inverse, k)
    per_pixel = torch.where(bg, target.gather(1, key), k)
    hole_sum = torch.zeros((n, k + 1), dtype=torch.float64)
    hole_sum.scatter_add_(1, per_pixel, prob.reshape(n, -1).double())
    hole_cnt = torch.zeros((n, k + 1), dtype=torch.long)
    hole_cnt.scatter_add_(1, per_pixel, torch.ones_like(per_pixel))
    return hole_sum[:, :k].float(), hole_cnt[:, :k].float()


def _hole_case(case):
    """(mask, fg_keyed, bg_keyed, prob, K) for a K6 case: a scene, a K3
    sweep mask at 70x97 with prob from a seed, or noise whose background
    components overflow bg slot K (K = 40)."""
    kind, name = case.split(":")
    rng = np.random.RandomState(9)
    k = K
    if kind == "scene":
        prob, thresh, _ = SCENES[name]()
        prob = prob[None]
        mask = prob > thresh
    elif kind == "sweep":
        mask = k3_sweep_mask(name, 70, 97)[None]
        prob = rng.rand(1, 70, 97).astype(np.float32)
    else:
        prob = rng.rand(2, 48, 61).astype(np.float32)
        mask, k = prob > 1.0 - float(name), 40
    prob, mask = torch.from_numpy(prob), torch.from_numpy(mask)
    keyed, _ = cc.compact_slots(cc.connected_components(mask), k)
    bg_labels = cc.connected_components(~mask, 4)
    if kind == "noise":
        roots = (bg_labels.reshape(2, -1) == torch.arange(48 * 61)).sum(1)
        assert bool((roots > k).all())        # bg slot K is shared
    bg_keyed, _ = cc.compact_slots(bg_labels, k)
    return mask, keyed, bg_keyed, prob, k


@pytest.mark.parametrize("case", [f"scene:{s}" for s in sorted(SCENES)]
                         + [f"sweep:{s}" for s in K3_SWEEP]
                         + ["noise:0.45", "noise:0.6"])
def test_route_by_table_gives_the_plain_holes(case):
    """The identities the K6 kernels rest on: the halo's column minima give
    the 8-neighbour min, the 0-filled table of K - enclosing gives the
    enclosing slot, and routing each bg pixel through it equals
    ``hole_stats_plain`` bit for bit (the same f64 sums in the same
    order), on nested rings, diagonal-sealed holes and overflow of bg
    slot K."""
    args = _hole_case(case)
    got = _route_by_table(*args)
    ref = cc.hole_stats_plain(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    if case in ("scene:nested_ring", "scene:diagonal_hole"):
        assert float(ref[1].sum()) > 0


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_rotated_boxes_match_jax(scene):
    """K5 with hole-filled scores: same valid slots, corners and sides
    within ``corner_tol``, scores within ``score_tol``."""
    prob, thresh, _ = SCENES[scene]()
    labels = cc.connected_components(_t(prob > thresh))
    corners_r, sides_r, scores_r, valid_r, _, _ = map(
        np.asarray, jcc.component_rotated_boxes(
            jnp.asarray(prob), jnp.asarray(labels[0].numpy()),
            max_components=K, num_angles=cc.NUM_ANGLES,
            hole_filled_score=True))
    corners, sides, scores, valid = cc.component_rotated_boxes(
        _t(prob), labels, max_components=K)
    np.testing.assert_array_equal(valid[0].numpy(), valid_r)
    v = valid_r
    assert np.abs(corners[0].numpy()[v] - corners_r[v]).max(
        initial=0.0) <= corner_tol(scene)
    assert np.abs(sides[0].numpy()[v] - sides_r[v]).max(
        initial=0.0) <= corner_tol(scene)
    assert np.abs(scores[0].numpy() - scores_r).max() <= score_tol(scene)


def _row_extreme_boxes(prob, keyed, valid_root, hole_sum, hole_cnt, k):
    """The K5 kernel's reduction in plain torch: the moments as in
    ``rotated_boxes_plain``, then each (slot, row)'s leftmost and rightmost
    pixel by ``scatter_reduce``, and the four angle stages over those
    points only, in the plain version's order of f32 operations. Within a
    row u and v are monotone in x, after rounding too, so the extents over
    the two extremes are those over every pixel."""
    n, h, w = prob.shape
    big = 1e9
    key = keyed.long()
    pix = torch.arange(h * w)
    xs, ys = (pix % w).expand(n, -1), (pix // w).expand(n, -1)
    fg = key < k
    drop = torch.where(fg, key, k)

    def seg(values, reduce, init=0):
        out = values.new_full((n, k + 1), init)
        out.scatter_reduce_(1, drop, values, reduce)
        return out[:, :k]

    count = seg(torch.ones_like(key), "sum")
    psum = seg(prob.reshape(n, -1).double(), "sum")
    safe = count.clamp(min=1).double()
    cx = (seg(xs, "sum").double() / safe).float()
    cy = (seg(ys, "sum").double() / safe).float()
    pad = torch.zeros((n, 1))
    dx = xs.float() - torch.cat([cx, pad], 1).gather(1, drop)
    dy = ys.float() - torch.cat([cy, pad], 1).gather(1, drop)
    zero = torch.zeros(())
    sxx, syy, sxy = (seg(torch.where(fg, a * b, zero).double(), "sum")
                     for a, b in ((dx, dx), (dy, dy), (dx, dy)))
    theta = 0.5 * torch.atan2(2.0 * sxy.float(), sxx.float() - syy.float())

    # each (slot, row) that holds a pixel gives its two extreme pixels
    cell = torch.where(fg, key * h + ys, k * h)
    xmin = torch.full((n, k * h + 1), w).scatter_reduce(1, cell, xs, "amin")
    xmax = torch.full((n, k * h + 1), -1).scatter_reduce(1, cell, xs, "amax")
    corners, sides = torch.empty((n, k, 4, 2)), torch.empty((n, k, 2))
    for i in range(n):
        held = torch.nonzero(xmin[i, :k * h] <= xmax[i, :k * h])[:, 0]
        slot = (held // h).repeat_interleave(2)
        px = torch.stack([xmin[i, held], xmax[i, held]], -1).reshape(-1)
        pdx = px.float() - cx[i, slot]
        pdy = (held % h).repeat_interleave(2).float() - cy[i, slot]
        th = theta[i]
        for offsets in cc.stage_offsets():
            off = torch.from_numpy(offsets)
            ang = th[None, :] + off[:, None]                      # (A, k)
            c, s = torch.cos(ang)[:, slot], torch.sin(ang)[:, slot]
            u = pdx * c + pdy * s
            v = -pdx * s + pdy * c
            index = slot.expand_as(u)
            exts = torch.stack([
                torch.full((len(off), k), big).scatter_reduce(
                    1, index, u, "amin"),
                torch.full((len(off), k), -big).scatter_reduce(
                    1, index, u, "amax"),
                torch.full((len(off), k), big).scatter_reduce(
                    1, index, v, "amin"),
                torch.full((len(off), k), -big).scatter_reduce(
                    1, index, v, "amax")], -1)                    # (A, k, 4)
            areas = ((exts[..., 1] - exts[..., 0])
                     * (exts[..., 3] - exts[..., 2]))
            best = torch.argmin(areas, dim=0)                     # first min
            th = th + off[best]
            ext = exts.gather(0, best[None, :, None].expand(1, -1, 4))[0]
        umin, umax, vmin, vmax = ext.unbind(-1)
        c, s = torch.cos(th), torch.sin(th)
        uc, vc = (umin + umax) / 2.0, (vmin + vmax) / 2.0
        ctr_x = cx[i] + uc * c - vc * s
        ctr_y = cy[i] + uc * s + vc * c
        hw, hh = (umax - umin) / 2.0, (vmax - vmin) / 2.0
        us = torch.stack([-hw, hw, hw, -hw], -1)
        vs = torch.stack([-hh, -hh, hh, hh], -1)
        corners[i] = torch.stack([ctr_x[:, None] + us * c[:, None]
                                  - vs * s[:, None],
                                  ctr_y[:, None] + us * s[:, None]
                                  + vs * c[:, None]], -1)
        sides[i] = torch.stack([umax - umin, vmax - vmin], -1)
    n_f = count.float()
    valid = valid_root & (n_f > 0)
    denom = n_f + hole_cnt
    scores = torch.where(valid & (denom > 0),
                         (psum.float() + hole_sum) / denom.clamp(min=1.0),
                         0.0)
    return corners, sides, scores, valid


def _row_extreme_case(case):
    """K5's inputs (prob, keyed, valid_root, hole_sum, hole_cnt, K) for a
    case: a scene and its flip, a K3 sweep mask at 70x97 with prob drawn
    from a seed, noise with more components than K (their slots from K3,
    K4 and K6), or a slot map drawn at random, whose slots have rows
    without a pixel between their first and last."""
    kind, name = case.split(":")
    rng = np.random.RandomState(5)
    if kind == "slots":
        k = 30
        keyed = rng.randint(0, k + 1, (2, 40 * 57)).astype(np.int32)
        keyed[keyed % 7 == 3] = k        # a few slots hold no pixel at all
        return (torch.from_numpy(rng.rand(2, 40, 57).astype(np.float32)),
                torch.from_numpy(keyed), torch.from_numpy(rng.rand(2, k) < .8),
                torch.from_numpy(rng.rand(2, k).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 5, (2, k)).astype(np.float32)),
                k)
    k = K
    if kind == "scene":
        prob, thresh, _ = SCENES[name]()
        prob = np.stack([prob, prob[::-1].copy()])
        mask = prob > thresh
    elif kind == "sweep":
        mask = np.stack([k3_sweep_mask(name, 70, 97, seed=i)
                         for i in range(2)])
        prob = rng.rand(2, 70, 97).astype(np.float32)
    else:
        prob = rng.rand(2, 48, 61).astype(np.float32)
        mask, k = prob > 1.0 - float(name), 40
    prob, mask = torch.from_numpy(prob), torch.from_numpy(mask)
    keyed, valid_root = cc.compact_slots(cc.connected_components(mask), k)
    if kind == "noise":
        assert int((keyed < k).sum()) < int(mask.sum())   # overflow
    bg_keyed, _ = cc.compact_slots(cc.connected_components(~mask, 4), k)
    return (prob, keyed, valid_root) + cc.hole_stats(mask, keyed, bg_keyed,
                                                     prob, k) + (k,)


@pytest.mark.parametrize("case", [f"scene:{s}" for s in sorted(SCENES)]
                         + [f"sweep:{s}" for s in K3_SWEEP]
                         + ["noise:0.2", "noise:0.3", "slots:random"])
def test_row_extremes_give_the_plain_result(case):
    """The identity the K5 kernel rests on: the angle search over each
    (slot, row)'s two extreme pixels equals ``rotated_boxes_plain`` over
    every pixel, bit for bit, overflow and empty slots included."""
    args = _row_extreme_case(case)
    got = _row_extreme_boxes(*args)
    ref = cc.rotated_boxes_plain(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert bool(ref[3].any()) == bool((args[1] < args[-1]).any())


def test_stage_offsets_match_jax_linspace():
    """The searched angle offsets agree with cc.py's f32 linspace to an
    ulp (XLA folds the linspace constants slightly differently per use)."""
    na = cc.NUM_ANGLES
    shrink = (na - 1) // 2 + 1
    span2 = 45.0 / (na + 1)
    spans = ((45.0, 2 * na + 3), (span2, na), (span2 / shrink, na),
             (span2 / shrink / shrink, na))
    for (span, count), got in zip(spans, cc.stage_offsets()):
        ref = np.asarray(jnp.linspace(-span, span, count)
                         * (jnp.pi / 180.0))
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.abs(got - ref).max() <= np.spacing(np.float32(1.0))


def test_batched_calls_match_per_image_calls():
    """The wrappers take a batch; each image's result equals its own call
    (labels stay per-image linear indices)."""
    scenes = [SCENES[name]()[0] for name in ("rot_rect", "low_score")]
    prob = torch.from_numpy(np.stack(scenes))
    corners, scores, keep = cc.device_boxes(prob)
    for i, p in enumerate(scenes):
        c1, s1, k1 = cc.device_boxes(_t(p))
        assert torch.equal(keep[i], k1[0])
        assert torch.equal(scores[i], s1[0])
        assert torch.equal(corners[i][k1[0]], c1[0][k1[0]])


def test_cpu_wrappers_launch_nothing():
    """CPU tensors take the plain versions: no kernel is built or counted."""
    cc.reset_launches()
    prob, thresh, box_thresh = SCENES["rot_rect"]()
    cc.device_boxes(_t(prob), thresh=thresh, box_thresh=box_thresh)
    assert all(v == 0 for v in cc.LAUNCHES.values())


def test_wrappers_reject_other_devices_and_types():
    with pytest.raises(ValueError):
        cc.connected_components(torch.zeros((1, 4, 4), dtype=torch.bool,
                                            device="meta"))
    with pytest.raises(TypeError):
        cc.connected_components(torch.zeros((1, 4, 4)))
    with pytest.raises(ValueError):
        cc.connected_components(torch.zeros((1, 4, 4), dtype=torch.bool), 6)
