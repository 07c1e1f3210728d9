"""The PyTorch port's serving handler and server against the JAX package's
handler (``infer_mode="flax"``, the plain fused-head path) on one .pth."""

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

from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.ops.pallas import cc as jcc
from db_text_minimal_tpu.serve.handler import \
    DBTextDetectionHandler as JaxHandler
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
            DBTextDetectionHandler(pth, device="cpu"))


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


@pytest.mark.parametrize("mode", ["folded", "int8"])
def test_unported_infer_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        DBTextDetectionHandler("x.pth", infer_mode=mode, device="cpu")


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
