"""The PyTorch port's serving handler and server against the JAX package's
handler on one .pth: the plain fused-head forward (``infer_mode="flax"``),
the BN-folded forward (``"folded"``, the default of both) and the int8 one
(``"int8"``); and ``build_inference_forward`` in each mode."""

import functools
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu.cli import common as jcommon
from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.ops.pallas import cc as jcc
from db_text_minimal_tpu.serve.handler import \
    DBTextDetectionHandler as JaxHandler
from db_text_minimal_tpu_torch.cli.common import build_inference_forward
from db_text_minimal_tpu_torch.serve import server as server_mod
from db_text_minimal_tpu_torch.serve.handler import DBTextDetectionHandler
from db_text_minimal_tpu_torch.serve.server import make_server
from db_text_minimal_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    v = jax.device_get(JaxDBTextModel().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    path = str(tmp_path_factory.mktemp("model") / "dbnet.pth")
    torch.save(state_dict_from_jax(v["params"], v["batch_stats"]), path)
    return path


@pytest.fixture(scope="module")
def request_bytes():
    from PIL import Image

    rs = np.random.RandomState(0)
    img = (rs.rand(480, 640, 3) * 60).astype(np.uint8)
    img[100:180, 80:400] = 230
    img[300:340, 200:600] = 200
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return [{"body": buf.getvalue()}]


@pytest.fixture(scope="module")
def handlers(pth):
    return (JaxHandler(pth, infer_mode="flax"),
            DBTextDetectionHandler(pth, infer_mode="flax", device="cpu"))


@pytest.fixture(scope="module")
def folded_handlers(pth):
    """(JAX, port) handler pairs of the folded modes, made once."""
    return {mode: (JaxHandler(pth, infer_mode=mode),
                   DBTextDetectionHandler(pth, infer_mode=mode, device="cpu"))
            for mode in ("folded", "int8")}


def test_masks_mode_matches_jax(handlers, request_bytes):
    """uint8 masks agree to one level: the two forwards differ by float
    noise, which can cross a ×255 truncation step."""
    ref = handlers[0].handle(request_bytes, mode="masks")
    got = handlers[1].handle(request_bytes, mode="masks")
    for key in ("prob_mask", "thresh_mask"):
        a, b = np.array(got[0][key]), np.array(ref[0][key])
        assert a.shape == b.shape == (640, 640)
        assert np.abs(a.astype(int) - b).max() <= 1


def test_boxes_mode_matches_jax(handlers, request_bytes, monkeypatch):
    """Box mode against the JAX handler with its connected-components round
    cap lifted: on this random-weight map the JAX default of 64 rounds
    splits components that the port's exact union-find keeps whole."""
    monkeypatch.setattr(jcc, "device_boxes",
                        functools.partial(jcc.device_boxes, num_iters=4096))
    ref = handlers[0].handle(request_bytes, mode="boxes")
    got = handlers[1].handle(request_bytes, mode="boxes")
    assert len(got[0]["boxes"]) == len(ref[0]["boxes"]) > 0
    np.testing.assert_allclose(got[0]["boxes"], ref[0]["boxes"], atol=1)
    np.testing.assert_allclose(got[0]["scores"], ref[0]["scores"], atol=1e-4)


def test_masks_png_mode_decodes_to_masks(handlers, request_bytes):
    import base64

    from PIL import Image

    masks = handlers[1].handle(request_bytes, mode="masks")[0]
    pngs = handlers[1].handle(request_bytes, mode="masks_png")[0]
    for key, png in (("prob_mask", "prob_png"), ("thresh_mask", "thresh_png")):
        img = np.array(Image.open(io.BytesIO(base64.b64decode(pngs[png]))))
        np.testing.assert_array_equal(img, np.array(masks[key], np.uint8))


def test_default_infer_mode_is_folded(pth):
    """Started as the JAX handler is, the port serves the same forward."""
    assert (DBTextDetectionHandler(pth, device="cpu").infer_mode
            == JaxHandler(pth).infer_mode == "folded")
    with pytest.raises(ValueError, match="module"):
        DBTextDetectionHandler(pth, infer_mode="module", device="cpu")


# masks: the largest uint8 level gap and the share of pixels more than one
# level apart. Folded: one level (float noise across a x255 truncation).
# int8 (dynamic scales): float noise moves an int8 activation across a
# rounding boundary now and then, and random weights carry each flip on;
# measured on this image: 0.64 % of pixels more than a level apart, a mean
# gap of 1.3 levels
MASK_TOLERANCE = {"folded": (1, 0.0, 0.02), "int8": (255, 0.01, 2.0)}


@pytest.mark.parametrize("mode", ["folded", "int8"])
def test_infer_modes_masks_match_jax(mode, folded_handlers, request_bytes):
    """Masks mode (the two-map forward) against the JAX handler's same
    mode."""
    jax_handler, handler = folded_handlers[mode]
    ref = jax_handler.handle(request_bytes, mode="masks")
    got = handler.handle(request_bytes, mode="masks")
    worst, share, mean = MASK_TOLERANCE[mode]
    for key in ("prob_mask", "thresh_mask"):
        a, b = np.array(got[0][key]), np.array(ref[0][key])
        assert a.shape == b.shape == (640, 640)
        gap = np.abs(a.astype(int) - b)
        assert gap.max() <= worst
        assert (gap > 1).mean() <= share
        assert gap.mean() <= mean


@pytest.mark.parametrize("mode", ["folded", "int8"])
def test_infer_modes_boxes_match_jax(mode, folded_handlers, request_bytes,
                                     monkeypatch):
    """Box mode (the prob-only forward, then the device postprocess)
    against the JAX handler's same mode, with its connected-components
    round cap lifted as in ``test_boxes_mode_matches_jax``: the same boxes,
    scores within 1e-4 (folded) and 1e-3 (int8; measured 4.1e-4)."""
    monkeypatch.setattr(jcc, "device_boxes",
                        functools.partial(jcc.device_boxes, num_iters=4096))
    jax_handler, handler = folded_handlers[mode]
    ref = jax_handler.handle(request_bytes, mode="boxes")
    got = handler.handle(request_bytes, mode="boxes")
    assert len(got[0]["boxes"]) == len(ref[0]["boxes"]) > 0
    np.testing.assert_allclose(got[0]["boxes"], ref[0]["boxes"], atol=1)
    np.testing.assert_allclose(got[0]["scores"], ref[0]["scores"],
                               atol=1e-4 if mode == "folded" else 1e-3)


def test_box_mode_takes_the_prob_only_forward(folded_handlers,
                                              request_bytes):
    """The folded handler's box-mode forward returns the prob map alone,
    equal to the first map of the masks-mode forward."""
    handler = folded_handlers["folded"][1]
    batch = handler.preprocess(request_bytes)
    prob = handler.inference(batch, prob_only=True)
    both = handler.inference(batch)
    assert prob.shape == (1, 640, 640, 1) and both.shape == (1, 640, 640, 2)
    assert torch.equal(prob[..., 0], both[..., 0])


@pytest.mark.parametrize("mode", ["folded", "int8"])
def test_build_inference_forward_matches_jax(mode, pth):
    """``build_inference_forward`` in each folded mode against the JAX one on a
    small batch: prob-only (N, H, W, 1) on both sides; folded within 5e-5,
    int8 (dynamic scales) within a mean of 0.01."""
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32) \
        * 2 - 1
    tree, forward = build_inference_forward(pth, infer_mode=mode,
                                            device="cpu")
    assert tree["params"]["backbone"]["layer3_0"]["conv1"]["kernel"].dtype \
        == (torch.int8 if mode == "int8" else torch.float32)
    _, variables, jforward = jcommon.build_inference_forward(pth,
                                                             infer_mode=mode)
    ref = np.asarray(jforward(variables, jnp.asarray(x)))
    got = forward(x).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 1)
    if mode == "folded":
        np.testing.assert_allclose(got, ref, atol=5e-5)
    else:
        assert np.abs(got - ref).mean() < 0.01


def test_server_passes_infer_mode(monkeypatch):
    """``--infer_mode`` (default folded) reaches ``make_server`` and from
    there the handler."""
    made = []

    class Recorder:
        initialized = True

        def __init__(self, model_path, infer_mode="folded", device="cuda"):
            made.append((model_path, infer_mode, device))

    class NoServer:
        def serve_forever(self):
            pass

    monkeypatch.setattr(server_mod, "DBTextDetectionHandler", Recorder)
    server = make_server("m.pth", port=0, infer_mode="int8", device="cpu")
    server.server_close()
    assert made == [("m.pth", "int8", "cpu")]
    calls = []
    monkeypatch.setattr(server_mod, "make_server",
                        lambda *a, **kw: calls.append(kw) or NoServer())
    server_mod.main(["--model_path", "m.pth", "--device", "cpu"])
    server_mod.main(["--model_path", "m.pth", "--infer_mode", "flax"])
    assert [kw["infer_mode"] for kw in calls] == ["folded", "flax"]
    with pytest.raises(SystemExit):
        server_mod.main(["--model_path", "m.pth", "--infer_mode", "bf16"])


def test_server_routes_modes_to_the_handler():
    """Micro-batching server plumbing with a stand-in handler: the query's
    mode reaches the handler, unknown modes fall back to masks."""

    class Echo:
        initialized = True

        def handle(self, request, mode="masks"):
            return [{"mode": mode, "size": len(r["body"])} for r in request]

    server = make_server("unused", port=0, handler=Echo())
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for query, want in (("?mode=boxes", "boxes"), ("", "masks"),
                            ("?mode=masks_png", "masks_png"),
                            ("?mode=bogus", "masks")):
            req = urllib.request.Request(
                f"http://localhost:{port}/predictions/dbtext{query}",
                data=b"abc", method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                assert json.loads(r.read()) == {"mode": want, "size": 3}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_jax_round_cap_splits_what_union_find_keeps(handlers, request_bytes):
    """The random-weight prob map of the boxes test: the JAX connected
    components stop at 64 rounds and split components there; the port's
    union-find equals the JAX result run to convergence."""
    from db_text_minimal_tpu_torch.ops import cc

    jax_handler = handlers[0]
    jax_handler.initialize()
    prob = np.asarray(jax_handler.inference(
        jax_handler.preprocess(request_bytes)))[0, ..., 0]
    mask = prob > 0.3
    capped = np.asarray(jcc.connected_components(jnp.asarray(mask,
                                                             jnp.int32)))
    full = np.asarray(jcc.connected_components(jnp.asarray(mask, jnp.int32),
                                               num_iters=4096))
    port = cc.connected_components(torch.from_numpy(mask)[None])[0].numpy()
    np.testing.assert_array_equal(port, full)
    n_capped = len(np.unique(capped[capped >= 0]))
    n_exact = len(np.unique(port[port >= 0]))
    assert (n_capped, n_exact) == (18462, 17574)
