"""The benchmark's plain reference agrees with the port at a small size on
the CPU, where the port computes in float32: the train-mode maps of both
configurations, the DB loss, the eval prob map of the served (BN-folded)
forward, and the rect-mode boxes and scores of a prob map."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT

from portbench.core import weights as W
from portbench.core.train_cell import CAFFE_MEAN
from portbench.reference import model as M
from portbench.reference import postprocess as RP
from portbench.reference import train as RT


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _port_model(cfg, weights, train):
    from db_text_minimal_tpu_torch.models import DBTextModel

    model = DBTextModel(backbone_name=cfg["backbone"], neck_name=cfg["neck"],
                        head_name=cfg["head"])
    model.load_state_dict(weights, strict=True)
    return model.train(train)


def _images(n, size, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 256, (n, size, size, 3),
                                        dtype=np.uint8))


# the 50-layer backbone's train-mode norms, over 2 · 2 · 2 values in
# layer4 at 64², amplify the float32 summation orders' difference
@pytest.mark.parametrize("name,atol", [("db_r18_fpn", 1e-4),
                                       ("db_r50_dcn", 1e-3)])
def test_train_mode_maps_match_the_port(name, atol):
    torch.backends.cudnn.allow_tf32 = False
    cfg = _cfg(name)
    weights = W.make(cfg, 3, "cpu")
    img = _images(2, 64)
    x = RT.images_to_input(img, CAFFE_MEAN)
    want = M.forward(weights, x, cfg, M.Ops("train"), train=True)
    got = _port_model(cfg, weights, True)(
        img.float() - torch.tensor(CAFFE_MEAN))
    got = got.permute(0, 3, 1, 2)
    # B̂ = σ(50 (P − T)) moves by up to 50/4 times the gap of P − T
    assert torch.allclose(got[:, :2], want[:, :2], atol=atol)
    assert torch.allclose(got[:, 2], want[:, 2], atol=20 * atol)


def test_db_loss_matches_the_port():
    from db_text_minimal_tpu_torch import losses as L

    cfg = _cfg("db_r18_fpn")
    g = torch.Generator().manual_seed(1)
    pred = torch.rand((2, 3, 32, 32), generator=g)
    gt = (torch.rand((2, 32, 32), generator=g) > 0.8).float()
    mask = (torch.rand((2, 32, 32), generator=g) > 0.1).float()
    thresh = 0.3 + 0.4 * torch.rand((2, 32, 32), generator=g)
    area = (torch.rand((2, 32, 32), generator=g) > 0.5).float()
    want = RT.db_loss(pred, gt, mask, thresh, area, cfg["loss"])
    lc = cfg["loss"]
    got = L.db_loss(pred.permute(0, 2, 3, 1), gt, mask, thresh, area,
                    alpha=lc["alpha"], beta=lc["beta"],
                    negative_ratio=lc["negative_ratio"],
                    reduction=lc["reduction"]).total_loss
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_served_prob_map_matches_the_folded_forward():
    from portbench.core import serve_cell as SC

    from portbench.core import scenes

    cfg = _cfg("db_r18_fpn")
    # scenes with words, as the cell serves, so that the head's scale is
    # calibrated as it is there
    img = np.stack([scenes.hard_scene(scenes.rng_for(2, 1, i), 320)[0]
                    for i in range(3)])
    weights = SC.serve_weights(cfg, 5, img, "cpu")
    server = SC.ProgramServer(cfg, {}, weights, "cpu")
    preds, out = server.call(img)
    want = SC.reference_maps(cfg, weights, img, "cpu")
    assert torch.allclose(preds[..., 0], want, atol=1e-5)
    assert len(out) == 3


def _blob_map(size=96):
    """Rotated bars at 0.9 on a 0.1 background, one with a hole."""
    import cv2

    prob = np.full((size, size), 0.1, np.float32)
    for (cx, cy, w, h, a) in ((30, 25, 36, 10, 20), (62, 60, 30, 14, -35),
                              (25, 72, 12, 24, 0)):
        box = cv2.boxPoints(((cx, cy), (w, h), a))
        cv2.fillPoly(prob, [np.round(box).astype(np.int32)], 0.9)
    prob[58:62, 60:64] = 0.2
    return prob


def test_boxes_match_the_port_rect_postprocess():
    from db_text_minimal_tpu_torch.postprocess import DeviceBoxRepresenter

    cfg = _cfg("db_r18_fpn")
    prob = _blob_map()
    rep = DeviceBoxRepresenter(**{k: cfg["postprocess"][k] for k in (
        "thresh", "box_thresh", "max_candidates", "unclip_ratio",
        "min_size")})
    boxes, scores = rep({"shape": [prob.shape]}, torch.from_numpy(prob)[None])
    want_boxes, want_scores, _ = RP.boxes(prob, cfg["postprocess"])
    assert len(want_boxes) == 3
    pairs = RP.match(boxes[0], want_boxes, 2.0)
    assert len(pairs) == len(boxes[0]) == 3
    assert max(abs(float(scores[0][i]) - want_scores[j])
               for i, j, _ in pairs) < 1e-5


def test_box_match_counts_an_altered_box():
    boxes = np.array([[[0, 0], [10, 0], [10, 5], [0, 5]]])
    moved = boxes + 3
    assert RP.match(boxes, moved, 2.0) == []
    assert len(RP.match(boxes, np.roll(boxes, 1, axis=1), 2.0)) == 1


def test_a_near_tie_matches_at_another_orientation_only():
    """A disc's rectangles at every angle are within a few percent of the
    least: the reference's box of that component at another angle
    matches where the tie allows it; the same box unclipped at another
    ratio does not."""
    import cv2

    cfg = _cfg("db_r18_fpn")
    pp = cfg["postprocess"]
    prob = np.full((96, 96), 0.1, np.float32)
    cv2.circle(prob, (48, 48), 14, 0.9, -1)
    want, _, cands = RP.boxes(prob, pp)
    assert len(want) == 1
    quads, excess = cands[0].boxes_near_least(0.1)
    k = int(np.argmax(excess))
    served = quads[k]
    assert 0.01 < excess[k] <= 0.1
    assert RP.match(served[None], want, 2.0) == []
    pairs = RP.match(served[None], want, 2.0, cands, 0.1)
    assert len(pairs) == 1 and pairs[0][2] <= excess[k]
    other = RP.Candidate(cands[0].hull, cands[0].area,
                         dict(pp, unclip_ratio=1.0), cands[0].shape)
    smaller = other.boxes_near_least(0.1)[0][k]
    assert RP.match(smaller[None], want, 2.0, cands, 0.1) == []

