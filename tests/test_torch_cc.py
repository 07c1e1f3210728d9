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
from torch_scenes import SCENES, corner_tol, score_tol

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
