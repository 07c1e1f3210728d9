"""The kernels on the card against their plain PyTorch versions: K3-K8
and P1 (CUDA) and K1, K2 forward and K2 backward (Triton); the int8
forward on the card against the CPU.

Needs an NVIDIA GPU, nvcc and Triton; skipped elsewhere. This file imports no JAX,
so it runs on the GPU machine, which has none, without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from db_text_minimal_tpu_torch.ops import cc
from db_text_minimal_tpu_torch.ops import db_step as D
from db_text_minimal_tpu_torch.ops import int8 as I
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


@pytest.mark.parametrize("width", [1, 7, 9, 100, 641])
def test_pack_bits_widths_match_plain_version(width, device):
    mask = torch.from_numpy(np.random.RandomState(width).rand(2, 33, width)
                            < 0.5).to(device)
    assert torch.equal(cc.pack_bits(mask), cc.pack_bits_plain(mask))


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
    forwards are bit-equal on the card; P1 launches 7 times in its int8
    form and 10 in its f32 form."""
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
    assert launches["int8_epilogue_int8"] == 7
    assert launches["int8_epilogue_f32"] == 10
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
