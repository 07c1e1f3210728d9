"""The PyTorch port's postprocess (``db_text_minimal_tpu_torch/postprocess.py``
and ``ops.cc.device_boxes``) against the JAX package's, on CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu import postprocess as jpost
from db_text_minimal_tpu.ops.pallas import cc as jcc
from db_text_minimal_tpu_torch import postprocess as tpost
from db_text_minimal_tpu_torch.ops import cc
from torch_scenes import SCENES, corner_tol, score_tol

torch.set_num_threads(1)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_device_boxes_match_jax(scene):
    """The batched composition K3 -> K4 -> K6 -> K5 -> filters, pre-unclip
    as the handler runs it: same kept slots, corners and scores within the
    JAX f32 sums' error (see test_torch_cc.py)."""
    prob, thresh, box_thresh = SCENES[scene]()
    c_ref, s_ref, k_ref = map(np.asarray, jcc.device_boxes(
        jnp.asarray(prob)[None], thresh=thresh, box_thresh=box_thresh,
        unclip=False))
    corners, scores, keep = cc.device_boxes(
        torch.from_numpy(prob)[None], thresh=thresh, box_thresh=box_thresh)
    np.testing.assert_array_equal(keep.numpy(), k_ref)
    kept = k_ref[0]
    assert np.abs(corners.numpy()[0][kept] - c_ref[0][kept]).max(
        initial=0.0) <= corner_tol(scene)
    assert np.abs(scores.numpy() - s_ref).max() <= score_tol(scene)


@pytest.mark.parametrize("scene", ["rot_rect", "speckles", "nested_ring"])
def test_device_representer_matches_jax(scene):
    prob, thresh, box_thresh = SCENES[scene]()
    batch = np.stack([prob, np.zeros_like(prob)])[..., None]
    shapes = {"shape": [(2 * prob.shape[0], 2 * prob.shape[1])] * 2}
    ref_boxes, ref_scores = jpost.DeviceBoxRepresenter(
        thresh=thresh, box_thresh=box_thresh)(shapes, jnp.asarray(batch))
    boxes, scores = tpost.DeviceBoxRepresenter(
        thresh=thresh, box_thresh=box_thresh)(shapes, torch.from_numpy(batch))
    for b, r, s, rs in zip(boxes, ref_boxes, scores, ref_scores):
        assert b.dtype == np.int16 and b.shape == r.shape
        np.testing.assert_array_equal(b, r)
        np.testing.assert_allclose(s, rs, atol=1e-5)


def test_device_boxes_match_host_rect_mode():
    """The port's device representer (the serving path's box code) against
    the port's host representer, the repo's own oracle: same count, final
    corners within 2.5 px."""
    prob, thresh, box_thresh = SCENES["rot_rect"]()
    batch = {"shape": [prob.shape]}
    dboxes, _ = tpost.DeviceBoxRepresenter(thresh, box_thresh)(
        batch, torch.from_numpy(prob)[None, ..., None])
    dev = sorted((np.asarray(b, float) for b in dboxes[0]),
                 key=lambda b: (b[0, 0], b[0, 1]))
    boxes, hscores = tpost.SegDetectorRepresenter(thresh, box_thresh)(
        batch, prob[None, ..., None])
    host = sorted((np.asarray(b, float) for b, s in zip(boxes[0], hscores[0])
                   if s > 0), key=lambda b: (b[0, 0], b[0, 1]))
    assert len(dev) == len(host) == 3
    for d, h in zip(dev, host):
        assert np.abs(d - h).max() < 2.5, (d, h)


@pytest.mark.parametrize("scene", ["rot_rect", "speckles", "nested_ring"])
def test_host_representer_matches_jax(scene):
    prob, thresh, box_thresh = SCENES[scene]()
    batch = {"shape": [prob.shape]}
    ref_boxes, ref_scores = jpost.SegDetectorRepresenter(
        thresh=thresh, box_thresh=box_thresh)(batch, prob[None, ..., None])
    boxes, scores = tpost.SegDetectorRepresenter(
        thresh=thresh, box_thresh=box_thresh)(batch, prob[None, ..., None])
    np.testing.assert_array_equal(boxes[0], ref_boxes[0])
    np.testing.assert_array_equal(scores[0], ref_scores[0])


def test_finish_device_rects_matches_jax():
    quads = np.array([
        [[10, 10], [60, 10], [60, 30], [10, 30]],
        [[5, 5], [5, 5], [5, 5], [5, 5]],
        [[100, 100], [101, 100], [101, 101], [100, 101]],
        [[20.3, 40.7], [70.1, 55.2], [66.4, 68.9], [16.6, 54.4]],
    ], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.75], np.float32)
    for q, s in ((quads, scores), (quads[:0], scores[:0])):
        ref = jpost.finish_device_rects(q, s, 160, 160, 320, 240)
        got = tpost.finish_device_rects(q, s, 160, 160, 320, 240)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_order_rect_points_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        quad = rng.rand(4, 2) * 100
        assert tpost.order_rect_points(quad) == jpost.order_rect_points(quad)


def test_polygon_mode_not_ported():
    with pytest.raises(NotImplementedError):
        tpost.DeviceBoxRepresenter()({"shape": [(8, 8)]},
                                     torch.zeros((1, 8, 8, 1)),
                                     is_output_polygon=True)
