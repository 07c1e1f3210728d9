"""The kernels on the card against their plain PyTorch versions: K3-K6
(CUDA) and K1, K2 forward and K2 backward (Triton).

Needs an NVIDIA GPU, nvcc and Triton; skipped elsewhere. This file imports no JAX,
so it runs on the GPU machine, which has none, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from db_text_minimal_tpu_torch.ops import cc
from db_text_minimal_tpu_torch.ops import db_step as D
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
