"""The PyTorch port's serving export (``serve/export``, ``cli/export``), the
handler serving a ``.pt2`` and the REST client, after the JAX package's
``tests/test_cli_serve.py`` (export round trip, symbolic batch with uint8
input, folded prob-only export, the export CLI, a prob-only export refusing
the masks modes, the server): each archive is held to the live forward of
its mode and, on the same weights, to the JAX model."""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.models import quant_infer as JQ
from db_text_minimal_tpu.models.head import fuse_variables as jax_fuse
from db_text_minimal_tpu.serve import export as jax_export
from db_text_minimal_tpu_torch.cli import export as export_cli
from db_text_minimal_tpu_torch.cli.common import (load_model,
                                                  load_state_dict,
                                                  make_folded_forward)
from db_text_minimal_tpu_torch.models import prune as P
from db_text_minimal_tpu_torch.ops import int8 as I
from db_text_minimal_tpu_torch.serve import client
from db_text_minimal_tpu_torch.serve.export import (export_model,
                                                    load_exported)
from db_text_minimal_tpu_torch.serve.handler import DBTextDetectionHandler
from db_text_minimal_tpu_torch.serve.server import make_server
from db_text_minimal_tpu_torch.utils import CAFFE_MEAN
from db_text_minimal_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

SIZE = 64
MODES = ("flax", "folded", "int8")
JAX_META_KEYS = ["uint8_input", "symbolic_batch", "input_shape",
                 "infer_mode", "prob_only"]


@pytest.fixture(scope="module")
def jax_variables():
    """Flax init (FusedDBHead layout) with every 1-D leaf nudged."""
    v = jax.device_get(JaxDBTextModel().init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rs = np.random.RandomState(1)

    def nudge(a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        return (a + np.abs(rs.randn(*a.shape)) * 0.05).astype(a.dtype)

    return {"params": jax.tree.map(nudge, v["params"]),
            "batch_stats": jax.tree.map(nudge, v["batch_stats"])}


@pytest.fixture(scope="module")
def pth(jax_variables, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("model") / "dbnet.pth")
    torch.save(state_dict_from_jax(jax_variables["params"],
                                   jax_variables["batch_stats"]), path)
    return path


def _uint8(batch: int, size: int = SIZE, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed + batch).randint(
        0, 255, (batch, size, size, 3)).astype(np.uint8)


def _source(pth, mode):
    if mode == "flax":
        return load_model(pth, device="cpu", fuse_head=True)
    return load_state_dict(pth, fuse_head=True)


def _live(pth, mode, prob_only):
    """The live forward of a mode on float (mean-subtracted) input."""
    if mode == "flax":
        model = load_model(pth, device="cpu", fuse_head=True)

        def forward(x):
            with torch.no_grad():
                y = model(torch.as_tensor(x))
            return y[..., :1] if prob_only else y
        return forward
    return make_folded_forward(load_state_dict(pth, fuse_head=True),
                               quantize=mode == "int8", prob_only=prob_only,
                               skip=(), device="cpu")


def _jax_ref(jax_variables, mode, x, prob_only):
    """JAX on the same weights: ``model.apply`` of the fused-head model for
    the flax and folded archives, the JAX int8 forward for int8."""
    fused = jax_fuse(jax_variables)
    with jax.default_matmul_precision("highest"):
        if mode == "int8":
            y = JQ.quant_dbnet_forward(
                JQ.prepare_quant_params(fused, skip=()), jnp.asarray(x),
                prob_only=prob_only)
        else:
            y = JaxDBTextModel(head_name="FusedDBHead").apply(
                fused, jnp.asarray(x), train=False)
            y = y[..., :1] if prob_only else y
    return np.asarray(y)


def _check_jax(got, ref, mode):
    """The JAX export tests' rule (at most 1 % of pixels more than 1e-3
    apart); int8 against the JAX int8 forward in f32 at
    tests/test_torch_quant.py's rule (a mean within 0.01)."""
    assert got.shape == ref.shape
    if mode == "int8":
        assert np.abs(got - ref).mean() < 0.01
    else:
        assert np.mean(np.abs(got - ref) > 1e-3) < 0.01


@pytest.mark.parametrize("mode", MODES)
def test_export_round_trip(mode, pth, jax_variables, tmp_path):
    """A fixed-batch float-input archive of each mode: the live forward's
    maps (atol 1e-5) and the JAX model's (JAX test_cli_serve.py:179-197)."""
    prob_only = mode != "flax"
    path = export_model(_source(pth, mode), str(tmp_path / "db.pt2"),
                        input_shape=(1, SIZE, SIZE, 3), uint8_input=False,
                        infer_mode=mode, prob_only=prob_only, device="cpu")
    infer = load_exported(path, device="cpu")
    assert not infer.meta["uint8_input"] and not infer.meta["symbolic_batch"]
    x = np.random.RandomState(0).rand(1, SIZE, SIZE, 3).astype(
        np.float32) * 255 - 128
    out = infer(x).numpy()
    assert out.shape == (1, SIZE, SIZE, 1 if prob_only else 2)
    live = _live(pth, mode, prob_only)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, live, rtol=0, atol=1e-5)
    _check_jax(out, _jax_ref(jax_variables, mode, x, prob_only), mode)


@pytest.mark.parametrize("mode", MODES)
def test_export_symbolic_batch_uint8(mode, pth, jax_variables, tmp_path):
    """One archive with a symbolic batch and uint8 input (the means
    subtracted in the graph) serves batch 1 and 3, against the live
    forward (atol 1e-5) and the JAX model (JAX test_cli_serve.py:
    200-258). The graph takes 2 or more images (torch.export specializes
    sizes 0 and 1), so batch 1 runs as its image twice: it equals the live
    forward of that pair (atol 1e-5) and the live batch of 1 up to the
    summation order of another batch size (the JAX export rule)."""
    prob_only = mode != "flax"
    path = export_model(_source(pth, mode), str(tmp_path / "db.pt2"),
                        input_shape=(None, SIZE, SIZE, 3), infer_mode=mode,
                        prob_only=prob_only, device="cpu")
    infer = load_exported(path, device="cpu")
    assert infer.meta["uint8_input"] and infer.meta["symbolic_batch"]
    assert infer.meta["infer_mode"] == mode
    assert infer.meta["prob_only"] == prob_only
    live = _live(pth, mode, prob_only)
    for batch in (1, 3):
        x = _uint8(batch)
        out = infer(x).numpy()
        assert out.shape == (batch, SIZE, SIZE, 1 if prob_only else 2)
        xf = x.astype(np.float32) - np.asarray(CAFFE_MEAN, np.float32)
        pair = np.concatenate([xf] * 2) if batch == 1 else xf
        ref = live(torch.from_numpy(pair))
        np.testing.assert_allclose(out, ref[:batch].numpy(), rtol=0,
                                   atol=1e-5)
        assert np.mean(np.abs(out - live(torch.from_numpy(xf)).numpy())
                       > 1e-3) < 0.01
        _check_jax(out, _jax_ref(jax_variables, mode, xf, prob_only), mode)


@pytest.mark.parametrize("mode", MODES)
def test_meta_keys_equal_jax(mode, pth, jax_variables, tmp_path):
    """The sidecar holds the JAX export's keys with the JAX values, and the
    compute dtype, device and torch version beside them."""
    from db_text_minimal_tpu.cli.common import load_model as jax_load_model

    jax_path = str(tmp_path / "db.stablehlo")
    model, variables = jax_load_model(pth, fuse_head=True)
    jax_export.export_model(model, variables, jax_path,
                            input_shape=(None, SIZE, SIZE, 3),
                            infer_mode=mode, prob_only=mode != "flax")
    with open(jax_path + ".meta.json") as f:
        ref = json.load(f)
    path = export_model(_source(pth, mode), str(tmp_path / "db.pt2"),
                        input_shape=(None, SIZE, SIZE, 3), infer_mode=mode,
                        prob_only=mode != "flax", device="cpu")
    with open(path + ".meta.json") as f:
        got = json.load(f)
    assert list(ref) == JAX_META_KEYS == list(got)[:5]
    assert {k: got[k] for k in JAX_META_KEYS} == ref
    assert got["compute_dtype"] == "float32" and got["device"] == "cpu"
    assert got["torch"] == torch.__version__


def test_int8_graph_holds_17_custom_op_nodes(pth, tmp_path):
    """The int8 archive keeps each int8 conv as one ``dbtext::int8_conv``
    node (the convolution with P1's epilogue; 17 with skip=()), with no
    ``torch._int_mm`` and no separate P1 node; on the CPU the op runs its
    plain version: no launch is counted."""
    path = export_model(_source(pth, "int8"), str(tmp_path / "db.pt2"),
                        input_shape=(None, SIZE, SIZE, 3), infer_mode="int8",
                        prob_only=True, device="cpu")
    program = torch.export.load(path)
    targets = [n.target for n in program.graph.nodes]
    assert targets.count(torch.ops.dbtext.int8_conv.default) == 17
    assert torch.ops.aten._int_mm.default not in targets
    assert torch.ops.dbtext.int8_epilogue.default not in targets
    I.reset_launches()
    load_exported(path, device="cpu")(_uint8(2))
    assert I.LAUNCHES["int8_conv"] == 0


def test_pruned_checkpoint_exports_at_its_widths(pth, tmp_path):
    """``cli.export`` of a pruned ``.pth`` (odd keeps: padded int8 GEMMs)
    writes its widths into the meta and gives the live pruned int8
    forward's maps."""
    pruned, widths = P.prune_dbnet_variables(
        load_state_dict(pth), backbone_keep=0.3, fpn_out_keep=130)
    src = str(tmp_path / "p.pth")
    torch.save(pruned, src)
    P.save_widths(src, widths)
    out = str(tmp_path / "p.pt2")
    export_cli.main(["--model_path", src, "--out", out, "--height",
                     str(SIZE), "--width", str(SIZE), "--infer_mode", "int8",
                     "--prob_only", "--device", "cpu"])
    infer = load_exported(out, device="cpu")
    assert infer.meta["widths"] == widths
    x = _uint8(2)
    live = make_folded_forward(load_state_dict(src, fuse_head=True),
                               quantize=True, prob_only=True, device="cpu")
    ref = live(x.astype(np.float32) - np.asarray(CAFFE_MEAN, np.float32))
    np.testing.assert_allclose(infer(x).numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def request_bytes():
    from PIL import Image
    import io

    rs = np.random.RandomState(0)
    img = (rs.rand(480, 640, 3) * 60).astype(np.uint8)
    img[100:180, 80:400] = 230
    img[300:340, 200:600] = 200
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return [{"body": buf.getvalue()}]


@pytest.fixture(scope="module")
def archives(pth, tmp_path_factory):
    """640-canvas archives: the folded prob-only one and the flax one."""
    root = tmp_path_factory.mktemp("pt2")
    return {mode: export_model(_source(pth, mode), str(root / f"{mode}.pt2"),
                               input_shape=(None, 640, 640, 3),
                               infer_mode=mode, prob_only=mode != "flax",
                               device="cpu")
            for mode in ("flax", "folded")}


def test_handler_serves_an_export_in_box_mode(pth, archives, request_bytes):
    """The handler on a ``.pt2`` in box mode gives the live handler's boxes
    (the same mode, ``infer_mode`` ignored for the export)."""
    got = DBTextDetectionHandler(archives["folded"], infer_mode="int8",
                                 device="cpu").handle(request_bytes,
                                                      mode="boxes")
    ref = DBTextDetectionHandler(pth, infer_mode="folded",
                                 device="cpu").handle(request_bytes,
                                                      mode="boxes")
    assert len(got[0]["boxes"]) == len(ref[0]["boxes"]) > 0
    np.testing.assert_allclose(got[0]["boxes"], ref[0]["boxes"], atol=1e-3)
    np.testing.assert_allclose(got[0]["scores"], ref[0]["scores"],
                               atol=1e-5)


def test_handler_serves_an_export_in_masks_mode(pth, archives,
                                                request_bytes):
    got = DBTextDetectionHandler(archives["flax"], device="cpu").handle(
        request_bytes, mode="masks")
    ref = DBTextDetectionHandler(pth, infer_mode="flax",
                                 device="cpu").handle(request_bytes,
                                                      mode="masks")
    for key in ("prob_mask", "thresh_mask"):
        a, b = np.array(got[0][key]), np.array(ref[0][key])
        assert a.shape == b.shape == (640, 640)
        assert np.abs(a.astype(int) - b).max() <= 1


def test_prob_only_export_refuses_masks_modes(archives, request_bytes):
    """A prob-only archive has no thresh map: the masks modes are refused
    up front with the JAX handler's message (JAX test_cli_serve.py:
    586-597)."""
    handler = DBTextDetectionHandler(archives["folded"], device="cpu")
    for mode in ("masks", "masks_png"):
        with pytest.raises(ValueError, match="prob_only"):
            handler.handle(request_bytes, mode=mode)
    assert handler.handle(request_bytes, mode="boxes")[0]["boxes"]


def test_export_cli(pth, tmp_path, request_bytes):
    """``cli.export`` end to end (JAX test_cli_serve.py:286-293), and a
    legacy float-input archive served with the means subtracted on the
    host."""
    out = str(tmp_path / "db.pt2")
    path = export_cli.main(["--model_path", pth, "--out", out, "--height",
                            "640", "--width", "640", "--float_input",
                            "--device", "cpu"])
    assert path == out and os.path.exists(out + ".meta.json")
    with open(out + ".meta.json") as f:
        meta = json.load(f)
    assert meta["infer_mode"] == "flax" and not meta["uint8_input"]
    got = DBTextDetectionHandler(out, device="cpu").handle(request_bytes,
                                                           mode="masks")
    ref = DBTextDetectionHandler(pth, infer_mode="flax",
                                 device="cpu").handle(request_bytes,
                                                      mode="masks")
    assert np.abs(np.array(got[0]["prob_mask"]).astype(int)
                  - np.array(ref[0]["prob_mask"])).max() <= 1
    with pytest.raises(SystemExit):
        export_cli.main(["--model_path", pth, "--infer_mode", "int8",
                         "--no_fuse_head", "--device", "cpu"])


@pytest.mark.parametrize("response", ["masks", "masks_png"])
def test_server_and_client_round_trip(response, archives, request_bytes,
                                      tmp_path):
    """The port's server on a flax ``.pt2`` and the port's client over
    HTTP on the CPU: the client writes the two masks the handler gives."""
    server = make_server(archives["flax"], port=0, device="cpu")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    image = tmp_path / "img.png"
    image.write_bytes(request_bytes[0]["body"])
    try:
        prob, thresh = client.main(client.load_args(
            ["--image_path", str(image), "--port", str(port), "--out_dir",
             str(tmp_path / "out"), "--response", response]))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    ref = DBTextDetectionHandler(archives["flax"], device="cpu").handle(
        request_bytes, mode="masks")[0]
    np.testing.assert_array_equal(prob, np.array(ref["prob_mask"]))
    np.testing.assert_array_equal(thresh, np.array(ref["thresh_mask"]))
    assert sorted(os.listdir(tmp_path / "out")) == ["foo1.jpg", "foo2.jpg"]
