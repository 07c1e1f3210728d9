"""The CUDA kernels K3-K6 on the card against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. This file imports no JAX,
so it runs on the GPU machine, which has none, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from db_text_minimal_tpu_torch.ops import cc
from torch_scenes import SCENES

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
