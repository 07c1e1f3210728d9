"""The frozen generator: the same seed gives the same pool, another seed
another one; the serving mix deals one set of aspect ratios in the seed's
order; the GT maps keep DBNet's label semantics."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.core import scenes, traffic as TG

TRAIN = {"kind": "train", "batch": 2, "image_size": 96, "pool_batches": 2}
SERVE = {"kind": "serve", "batch": 3, "canvas": 96, "long_side": 128,
         "aspect_min": 0.5, "aspect_max": 2.0, "pool_batches": 2,
         "scenes": 3}


@pytest.mark.parametrize("traffic", [TRAIN, SERVE], ids=["train", "serve"])
def test_the_pool_is_a_function_of_the_seed(traffic):
    big = 2 ** 31 + 5
    a = TG.make_pool(traffic, big, workers=1)
    b = TG.make_pool(traffic, big, workers=1)
    c = TG.make_pool(traffic, big + 1, workers=1)
    flat = (lambda p: [v for b in p for v in (b.values() if isinstance(b, dict)
                                              else [b])])
    assert all(np.array_equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(flat(a), flat(c)))


def test_worker_processes_make_the_same_pool():
    assert all(np.array_equal(x, y) for x, y in zip(
        TG.make_pool(SERVE, 9, workers=1), TG.make_pool(SERVE, 9, workers=2)))


def test_every_seed_gets_the_same_aspect_ratios():
    a, b = TG.serve_aspects(SERVE, 1), TG.serve_aspects(SERVE, 2)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    assert np.isclose(a.min(), 0.5) and np.isclose(a.max(), 2.0)


def test_serve_canvases_are_padded_at_their_aspect():
    pool = TG.make_pool(SERVE, 3, workers=1)
    aspects = TG.serve_aspects(SERVE, 3)
    for img, aspect in zip(np.concatenate(pool), aspects):
        rows = np.nonzero(img.any(axis=(1, 2)))[0]
        cols = np.nonzero(img.any(axis=(0, 2)))[0]
        h, w = rows.max() + 1, cols.max() + 1
        assert max(h, w) == 96
        assert abs(w / h - aspect) < 0.1 * aspect + 0.05


def test_gt_maps_of_a_rectangle():
    """A 60 × 20 word: shrunk by d = A(1 − 0.4²)/L = 6.3 on each side, the
    threshold map 0.7 on its border falling to 0.3 at d outside."""
    words = [(np.array([[20.0, 30.0], [80.0, 30.0], [80.0, 50.0],
                        [20.0, 50.0]]), "WORD")]
    gt, mask, thresh, area = scenes.gt_maps(words, 100)
    d = 60 * 20 * (1 - 0.16) / 160
    ys, xs = np.nonzero(gt)
    assert abs(xs.min() - (20 + d)) <= 1 and abs(xs.max() - (80 - d)) <= 1
    assert abs(ys.min() - (30 + d)) <= 1 and abs(ys.max() - (50 - d)) <= 1
    assert mask.min() == 1.0
    assert np.isclose(thresh[30, 50], 0.7) and np.isclose(thresh[0, 0], 0.3)
    assert area[30 - 5, 50] == 1.0 and area[30 - 8, 50] == 0.0


def test_ignored_and_small_words_are_masked_out():
    poly = np.array([[10.0, 10.0], [40.0, 10.0], [40.0, 30.0], [10.0, 30.0]])
    tiny = np.array([[60.0, 60.0], [90.0, 60.0], [90.0, 64.0], [60.0, 64.0]])
    gt, mask, _, _ = scenes.gt_maps([(poly, scenes.IGNORE_TAG),
                                     (tiny, "AB")], 100)
    assert gt.sum() == 0
    assert mask[20, 20] == 0 and mask[62, 70] == 0 and mask[50, 50] == 1
