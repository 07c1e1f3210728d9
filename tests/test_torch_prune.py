"""The PyTorch port's structured pruning (``models/prune``, ``cli/prune``)
against the JAX package's, case by case after ``tests/test_prune.py``: the
same Flax weights are pruned by the JAX package and, carried by
``weights.state_dict_from_jax``, by the port; the pruned state_dicts and
widths are equal exactly, and the pruned forwards agree. Then the widths
through the loaders, the folded and int8 forwards (K and N padded for the
card's int8 GEMM), the checkpoint policy, the trainer and
``quality_bench``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu.cli import prune as jax_prune_cli
from db_text_minimal_tpu.models import DBTextModel as JaxDBTextModel
from db_text_minimal_tpu.models import prune as JP
from db_text_minimal_tpu.models import quant_infer as JQ
from db_text_minimal_tpu.models.head import fuse_variables as jax_fuse
from db_text_minimal_tpu.train.checkpoints import \
    save_checkpoint as jax_save_checkpoint
from db_text_minimal_tpu_torch.cli import prune as prune_cli
from db_text_minimal_tpu_torch.cli.common import (build_inference_forward,
                                                  load_model)
from db_text_minimal_tpu_torch.models import DBTextModel
from db_text_minimal_tpu_torch.models import prune as P
from db_text_minimal_tpu_torch.models import quant_infer as Q
from db_text_minimal_tpu_torch.models.head import fuse_variables
from db_text_minimal_tpu_torch.ops import int8 as I
from db_text_minimal_tpu_torch.train.checkpoints import CheckpointPolicy
from db_text_minimal_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)

ATOL = 5e-5   # the repo's model parity tolerance (tests/test_models.py)
X = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (1, 64, 64, 3)))
BLOCKS = ["layer1_0", "layer1_1", "layer2_0", "layer2_1", "layer3_0",
          "layer3_1", "layer4_0", "layer4_1"]
# (backbone_keep, fpn_inner_keep, fpn_out_keep): each group alone, all
# three (the JAX p50), counts, and odd keeps whose widths leave K and N of
# the int8 GEMMs off multiples of 8
KEEPS = {"backbone": (0.5, None, None), "fpn_inner": (1.0, 0.75, None),
         "fpn_out": (1.0, None, 0.5), "p50": (0.5, 0.75, 0.5),
         "counts": (40, 20, 100), "odd": (0.3, 1.0, 130)}


def _tree_np(t):
    return jax.tree.map(lambda a: np.array(a), t)   # writable copies


@pytest.fixture(scope="module")
def variables():
    """The JAX test's init (PRNGKey 7) with every 1-D leaf moved by seeded
    noise, so that the BN-folded scores are not the kernel norms alone."""
    v = jax.device_get(JaxDBTextModel().init(
        jax.random.PRNGKey(7), jnp.zeros((1, 64, 64, 3)), train=False))
    rs = np.random.RandomState(1)

    def nudge(a):
        a = np.asarray(a)
        if a.ndim != 1:
            return np.array(a)
        return (a + np.abs(rs.randn(*a.shape)) * 0.05).astype(a.dtype)

    return {"params": jax.tree.map(nudge, v["params"]),
            "batch_stats": jax.tree.map(nudge, v["batch_stats"])}


def _sd(v):
    return state_dict_from_jax(v["params"], v["batch_stats"])


def _prune_both(v, keeps):
    b, i, o = keeps
    ref, ref_w = JP.prune_dbnet_variables(_tree_np(v), backbone_keep=b,
                                          fpn_inner_keep=i, fpn_out_keep=o)
    got, got_w = P.prune_dbnet_variables(_sd(v), backbone_keep=b,
                                         fpn_inner_keep=i, fpn_out_keep=o)
    return (ref, ref_w), (got, got_w)


def _assert_sd_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


def _port_forward(sd, widths, head="DBHead", x=X):
    model = DBTextModel(head_name=head,
                        **P.widths_to_model_kwargs(widths)).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(x))).numpy()


def _jax_forward(v, widths, head="DBHead", x=X):
    with jax.default_matmul_precision("highest"):
        return np.asarray(JaxDBTextModel(
            head_name=head, **JP.widths_to_model_kwargs(widths)).apply(
                v, jnp.asarray(x), train=False))


# ----------------------------------------------------- the pruned trees ---

@pytest.mark.parametrize("name", sorted(KEEPS))
def test_pruned_state_dict_equals_jax(name, variables):
    """The port's pruned state_dict is ``state_dict_from_jax`` of the JAX
    package's pruned tree, bit for bit, with the same widths."""
    (ref, ref_w), (got, got_w) = _prune_both(variables, KEEPS[name])
    assert got_w == ref_w and list(got_w) == list(ref_w)
    _assert_sd_equal(got, _sd(ref))


@pytest.mark.parametrize("name", ["backbone", "fpn_inner", "fpn_out", "p50"])
def test_pruned_forward_matches_jax(name, variables):
    """Each group alone and all three: the port's pruned model against
    JAX ``DBTextModel(**widths).apply`` at the model tolerance."""
    (ref, ref_w), (got, got_w) = _prune_both(variables, KEEPS[name])
    out = _port_forward(got, got_w)
    assert out.shape == (1, 64, 64, 2)
    np.testing.assert_allclose(out, _jax_forward(ref, ref_w), atol=ATOL)


def test_ties_fall_as_numpy_argsort(variables):
    """Channels whose scores tie exactly (copies of one channel) are kept
    or dropped as JAX's ``np.argsort(scores)[::-1]`` keeps them."""
    v = _tree_np(variables)
    blk = v["params"]["backbone"]["layer2_0"]
    sblk = v["batch_stats"]["backbone"]["layer2_0"]
    for c in range(1, 128, 2):           # 64 pairs of equal channels
        blk["conv1"]["kernel"][..., c] = blk["conv1"]["kernel"][..., c - 1]
        for leaf in ("scale", "bias"):
            blk["bn1"][leaf][c] = blk["bn1"][leaf][c - 1]
        for leaf in ("mean", "var"):
            sblk["bn1"][leaf][c] = sblk["bn1"][leaf][c - 1]
    (ref, ref_w), (got, got_w) = _prune_both(v, (0.25, None, None))
    assert got_w == ref_w
    _assert_sd_equal(got, _sd(ref))


def test_dead_channels_dropped_exactly_when_only_that_block_prunable(
        variables):
    """The last 64 conv1 channels of layer3_0 made dead; keep 192 of 256
    drops exactly them, and with every other block left whole the forward
    is unchanged (JAX test_prune.py:49-83)."""
    v = _tree_np(variables)
    blk = v["params"]["backbone"]["layer3_0"]
    sblk = v["batch_stats"]["backbone"]["layer3_0"]
    dead = np.arange(256 - 64, 256)
    blk["conv1"]["kernel"][..., dead] = 0.0
    blk["bn1"]["scale"][dead] = 0.0
    blk["bn1"]["bias"][dead] = 0.0
    sblk["bn1"]["mean"][dead] = 0.0
    sblk["bn1"]["var"][dead] = 1.0
    full = _sd(v)
    y_full = _port_forward(full, None)
    pruned, widths = P.prune_dbnet_variables(full, backbone_keep=0.75)
    hidden = list(widths["backbone_hidden"])
    for i, name in enumerate(BLOCKS):
        if name == "layer3_0":
            continue
        hidden[i] = 0
        stage, block = name[5], name[7]
        prefix = f"backbone.layer{stage}.{block}."
        pruned.update({k: t for k, t in full.items()
                       if k.startswith(prefix)})
    assert pruned["backbone.layer3.0.conv1.weight"].shape[0] == 192
    y = _port_forward(pruned, {"backbone_hidden": hidden})
    np.testing.assert_allclose(y, y_full, atol=1e-4)


def test_fpn_groups_shapes_and_forward(variables):
    pruned, widths = P.prune_dbnet_variables(
        _sd(variables), fpn_inner_keep=0.75, fpn_out_keep=0.5)
    assert widths == {"fpn_inner_quarter": 48, "head_width": 64,
                      "fpn_out": 128}
    assert pruned["segmentation_body.reduce_conv_c5.conv.weight"].shape == (
        48, 512, 1, 1)
    assert pruned["segmentation_body.smooth_p2.conv.weight"].shape == (
        48, 48, 3, 3)
    assert pruned["segmentation_body.conv.0.weight"].shape == (
        128, 192, 3, 3)
    assert pruned["segmentation_head.binarize.0.weight"].shape == (
        64, 128, 3, 3)
    y = _port_forward(pruned, widths)
    assert y.shape == (1, 64, 64, 2) and 0 <= y.min() and y.max() <= 1


def test_combined_pruning_param_reduction_and_fusion(variables):
    """p50 keeps half the parameters (the JAX report's ratio, .5048 of the
    resnet18 model); the fused head stays weight-equivalent on the pruned
    model."""
    full = _sd(variables)
    pruned, widths = P.prune_dbnet_variables(
        full, backbone_keep=0.5, fpn_inner_keep=0.75, fpn_out_keep=0.5)
    ratio = prune_cli._n_params(pruned) / prune_cli._n_params(full)
    assert round(ratio, 4) == 0.5048
    y = _port_forward(pruned, widths)
    y_f = _port_forward(fuse_variables(pruned), widths, head="FusedDBHead")
    np.testing.assert_allclose(y_f, y, atol=2e-5)


def test_dcn_blocks_left_unpruned(variables):
    """A block whose conv2 has an offset branch (a deformable conv) or a
    Bottleneck's conv3 is left whole; the others prune."""
    sd = _sd(variables)
    sd["backbone.layer2.0.conv2.offset_conv.weight"] = torch.zeros(1)
    sd["backbone.layer3.1.conv3.weight"] = torch.zeros(1)
    _, widths = P.prune_dbnet_variables(sd, backbone_keep=0.5)
    assert widths["backbone_hidden"] == [32, 32, 0, 64, 128, 0, 256, 256]


def test_prunable_guard_int_vs_float_semantics():
    for keep, want in ((None, False), (1.0, False), (0.5, True), (1, True),
                       (128, True), (True, False)):
        assert P._prunable(keep) is want is JP._prunable(keep)
    scores = np.arange(8, dtype=np.float64)
    assert P._keep_indices(scores, 1).tolist() == [7]
    assert P._keep_indices(scores, 0.5).tolist() == [4, 5, 6, 7]
    rs = np.random.RandomState(0)
    for keep in (1, 3, 0.3, 0.5, 0.99, 100):
        scores = rs.randint(0, 4, 37).astype(np.float64)   # many ties
        np.testing.assert_array_equal(P._keep_indices(scores, keep),
                                      JP._keep_indices(scores, keep))


def test_prune_cli_keep_arg_parses_counts_and_fractions():
    for s in ("0.5", "1", "128", "130", "0.3"):
        got, ref = prune_cli._keep_arg(s), jax_prune_cli._keep_arg(s)
        assert got == ref and type(got) is type(ref)


def test_widths_sidecar_roundtrip(tmp_path):
    widths = {"backbone_hidden": [0, 32, 0, 64, 0, 0, 256, 0],
              "fpn_inner_quarter": 48, "fpn_out": 128, "head_width": 64}
    ckpt = str(tmp_path / "m.ckpt")
    P.save_widths(ckpt, widths)
    assert P.load_widths(ckpt) == widths == JP.load_widths(ckpt)
    assert P.load_widths(str(tmp_path / "missing.ckpt")) is None
    kw = P.widths_to_model_kwargs(P.load_widths(ckpt))
    assert kw == JP.widths_to_model_kwargs(widths)
    assert kw["backbone_hidden"] == (0, 32, 0, 64, 0, 0, 256, 0)
    assert P.widths_to_model_kwargs(None) == {}


# ---------------------------------------------------------- cli.prune ----

def _both_clis(variables, tmp_path, argv_keeps, src=None):
    """cli.prune of both packages on the same weights; returns the two
    reports and output paths."""
    if src is None:
        jsrc = str(tmp_path / "full.ckpt")
        jax_save_checkpoint(jsrc, {"params": variables["params"],
                                   "batch_stats": variables["batch_stats"]})
        psrc = str(tmp_path / "full.pth")
        torch.save(_sd(variables), psrc)
        with open(psrc + ".train_config.json", "w") as f:
            json.dump({"epochs": 10}, f)
    else:
        jsrc, psrc = src
    tag = "".join(argv_keeps).replace("-", "").replace(".", "")
    jout, pout = (str(tmp_path / f"j{tag}.ckpt"),
                  str(tmp_path / f"p{tag}.pth"))
    ref = jax_prune_cli.main(jax_prune_cli.load_args(
        ["--checkpoint", jsrc, "--out", jout] + argv_keeps))
    got = prune_cli.main(prune_cli.load_args(
        ["--checkpoint", psrc, "--out", pout, "--device", "cpu"]
        + argv_keeps))
    return ref, got, (jsrc, psrc), (jout, pout)


def test_prune_cli_end_to_end_matches_jax(variables, tmp_path):
    """The port's cli.prune against the JAX CLI's report (widths, counts,
    ratios), its sidecars, and its checkpoint loaded by ``load_model`` at
    the widths against the JAX ``load_model`` of the JAX CLI's output."""
    from db_text_minimal_tpu.cli.common import load_model as jax_load_model

    ref, got, _, (jout, pout) = _both_clis(
        variables, tmp_path, ["--backbone_keep", "0.5", "--fpn_inner_keep",
                              "0.75", "--fpn_out_keep", "0.5"])
    assert {k: v for k, v in got.items() if k != "out"} == \
        {k: v for k, v in ref.items() if k != "out"}
    assert P.load_widths(pout) == ref["widths"]
    with open(pout + ".train_config.json") as f:
        assert json.load(f) == {"epochs": 10}
    model = load_model(pout, device="cpu")
    with torch.no_grad():
        y = model(torch.from_numpy(X)).numpy()
    jm, jv = jax_load_model(jout)
    with jax.default_matmul_precision("highest"):
        y_ref = np.asarray(jm.apply(jv, jnp.asarray(X), train=False))
    np.testing.assert_allclose(y, y_ref, atol=ATOL)


def test_reprune_merges_widths_sidecar(variables, tmp_path):
    """Pruning a pruned checkpoint keeps the source sidecar's widths for
    the groups the second pass leaves alone, as the JAX CLI does."""
    _, _, src, (j1, p1) = _both_clis(variables, tmp_path,
                                     ["--backbone_keep", "0.5"])
    ref, got, _, (j2, p2) = _both_clis(variables, tmp_path,
                                       ["--fpn_out_keep", "0.5"],
                                       src=(j1, p1))
    assert got["widths"] == ref["widths"]
    assert P.load_widths(p2)["backbone_hidden"] == \
        P.load_widths(p1)["backbone_hidden"]
    assert got["widths"]["fpn_out"] and got["widths"]["head_width"]
    with torch.no_grad():
        y = load_model(p2, device="cpu")(torch.from_numpy(X))
    assert y.shape == (1, 64, 64, 2)


def test_prune_cli_writes_a_checkpoint_of_weights(variables, tmp_path):
    """An ``--out`` other than ``.pth`` is a checkpoint of the weights
    alone, which ``load_model`` reads at its widths."""
    src = str(tmp_path / "full.pth")
    torch.save(_sd(variables), src)
    out = str(tmp_path / "p.ckpt")
    prune_cli.main(prune_cli.load_args(
        ["--checkpoint", src, "--out", out, "--backbone_keep", "0.5",
         "--device", "cpu"]))
    model = load_model(out, device="cpu")
    assert model.backbone.layer1[0].conv1.weight.shape[0] == 32


# -------------------------------------------- folded and int8 forwards ---

@pytest.fixture
def f64_float_convs(monkeypatch):
    """Both forwards' float convs in f64 (outputs rounded to f32, as both
    forwards do): summation order stops mattering
    (tests/test_torch_quant.py)."""
    monkeypatch.setattr(JQ, "_compute_dtype", lambda: jnp.float64)
    with jax.enable_x64(True):
        yield torch.float64


def _int8_inputs_run(jq, x):
    recorded = []
    conv = jax.lax.conv_general_dilated

    def recording(lhs, rhs, *args, **kwargs):
        if lhs.dtype == jnp.int8:
            recorded.append(np.asarray(lhs))
        return conv(lhs, rhs, *args, **kwargs)

    jax.lax.conv_general_dilated = recording
    try:
        out = np.asarray(JQ.quant_dbnet_forward(jq, jnp.asarray(x)))
    finally:
        jax.lax.conv_general_dilated = conv
    return out, recorded


@pytest.mark.parametrize("name", ["p50", "odd"])
def test_pruned_folded_forward_matches_flax(name, variables):
    """The folded forward of a pruned tree is weight-exact: within 2e-4 of
    the pruned fused-head model (JAX test_prune.py:186)."""
    _, (got, widths) = _prune_both(variables, KEEPS[name])
    fused = fuse_variables(got)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    ref = _port_forward(fused, widths, head="FusedDBHead", x=x)
    qv = Q.prepare_quant_params(fused, skip=(), min_out_channels=10 ** 9)
    with torch.inference_mode():
        y = Q.quant_dbnet_forward(qv, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, ref, atol=2e-4)


@pytest.mark.parametrize("name", ["p50", "odd"])
def test_pruned_int8_forward_matches_jax_exactly(name, variables,
                                                 f64_float_convs):
    """The int8 forward of a pruned tree (the port's own preparation, with
    its padded GEMMs) against the JAX package's on its pruned tree, float
    convs in f64 on both sides (tests/test_torch_quant.py's int8 rule):
    every int8 activation equal, the maps within 1e-6."""
    (ref_v, _), (got, _) = _prune_both(variables, KEEPS[name])
    x = np.random.RandomState(0).rand(2, 128, 128, 3).astype(
        np.float32) * 2 - 1
    jq = JQ.prepare_quant_params(jax_fuse(ref_v), skip=())
    ref, ref_q = _int8_inputs_run(jq, x)
    qv = Q.prepare_quant_params(fuse_variables(got), skip=())
    got_q = []
    with torch.inference_mode():
        y = Q.quant_dbnet_forward(qv, torch.from_numpy(x),
                                  compute_dtype=f64_float_convs,
                                  int8_inputs=got_q).numpy()
    assert len(got_q) == len(ref_q) > 0
    for a, b in zip(got_q, ref_q):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-6)


def _walk(tree, path=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, f"{path}/{key}")
        elif key == "kernel":
            yield path, tree


def test_odd_keeps_pad_k_and_n_to_multiples_of_8(variables, monkeypatch):
    """At odd keeps the int8 GEMMs' K and N are padded to multiples of 8
    (w_cols, eff_scale, bias) where they are not already, and the padded
    forward gives the bits of the same forward on the unpadded tree with
    the int8 conv's plain version (its kernel takes Cout in multiples of
    8)."""
    _, (got, _) = _prune_both(variables, KEEPS["odd"])
    qv = Q.prepare_quant_params(fuse_variables(got), skip=())
    padded = []
    for path, node in _walk(qv):
        if node["kernel"].dtype != torch.int8:
            continue
        cout = node["kernel"].shape[0]
        k = node["kernel"][0].numel()
        if "w_cols" not in node:
            assert cout % 8 == 0 and k % 8 == 0, path
            continue
        padded.append(path)
        w = node["w_cols"]
        assert w.shape[0] % 8 == 0 and w.shape[1] % 8 == 0, path
        assert (w.shape[0] - cout < 8 and w.shape[1] - k < 8
                and (w.shape[0], w.shape[1]) != (cout, k))
        assert torch.equal(w[:cout, :k], node["kernel"].reshape(cout, k))
        assert not w[cout:].any() and not w[:, k:].any()
        for key in ("eff_scale", "bias"):
            assert node[key].shape == (w.shape[0],)
            assert not node[key][cout:].any()
    # layer3's conv2 (K = 9 * 77) and layer4's (N = 154, K = 9 * 154), the
    # FPN output conv (N = 130) and the head's conv1 (K = 9 * 130)
    assert "/params/segmentation_body/conv" in padded
    assert "/params/segmentation_head/conv1" in padded
    assert "/params/backbone/layer3_0/conv2" in padded

    def unpad(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = unpad(value)
            elif key != "w_cols":
                out[key] = value
        if "w_cols" in tree:
            cout = tree["kernel"].shape[0]
            out["eff_scale"] = tree["eff_scale"][:cout].contiguous()
            out["bias"] = tree["bias"][:cout].contiguous()
        return out

    plain = unpad(qv)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        2, 64, 64, 3).astype(np.float32))
    with torch.inference_mode():
        a = Q.quant_dbnet_forward(qv, x)
        monkeypatch.setattr(Q, "int8_conv", I.int8_conv_plain)
        b = Q.quant_dbnet_forward(plain, x)
    assert torch.equal(a, b)


def test_build_inference_forward_applies_the_sidecar(variables, tmp_path):
    """``build_inference_forward`` and ``load_model`` on a pruned ``.pth``
    with its sidecar: flax at the widths, folded and int8 on the narrow
    weights; folded within 2e-4 of flax."""
    pruned, widths = P.prune_dbnet_variables(
        _sd(variables), backbone_keep=0.3, fpn_out_keep=130)
    path = str(tmp_path / "p.pth")
    torch.save(pruned, path)
    P.save_widths(path, widths)
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    model, flax = build_inference_forward(path, infer_mode="flax",
                                          device="cpu")
    assert model.segmentation_body.out_channels == 130
    ref = flax(x).numpy()
    _, folded = build_inference_forward(path, infer_mode="folded",
                                        prob_only=False, device="cpu")
    np.testing.assert_allclose(folded(x).numpy(), ref, atol=2e-4)
    _, int8 = build_inference_forward(path, infer_mode="int8", device="cpu")
    y8 = int8(x).numpy()
    assert y8.shape == (1, 64, 64, 1) and np.abs(y8 - ref[..., :1]).mean() \
        < 0.02


# ------------------------------------- policy, trainer, quality_bench ---

def test_checkpoint_policy_writes_the_sidecar(tmp_path):
    widths = {"fpn_out": 128, "head_width": 64}
    policy = CheckpointPolicy(str(tmp_path), "best.ckpt", "last.ckpt",
                              "hmean.ckpt", widths=widths)
    saved = policy.on_epoch_end({"step": 1}, train_loss=1.0, test_loss=1.0,
                                hmean=0.5, epoch=0)
    saved.append(policy.on_train_end({"step": 1}, 1))
    assert len(saved) == 3
    for path in saved:
        assert P.load_widths(path) == widths


def test_trainer_with_widths_takes_2_steps(variables, tmp_path):
    """A Trainer given a pruned checkpoint's widths builds the narrow
    model, resumes the pruned weights and takes 2 steps (loss finite, the
    weights moved, still narrow); its checkpoints carry the sidecar."""
    from db_text_minimal_tpu_torch.config import default_config
    from db_text_minimal_tpu_torch.data.scenes import text_batch
    from db_text_minimal_tpu_torch.train.trainer import Trainer

    pruned, widths = P.prune_dbnet_variables(
        _sd(variables), backbone_keep=0.5, fpn_inner_keep=0.75,
        fpn_out_keep=0.5)
    path = str(tmp_path / "p50.pth")
    torch.save(pruned, path)
    cfg = default_config()
    cfg.meta.device = "cpu"
    cfg.meta.root_dir = str(tmp_path)
    cfg.hps.img_size = 64
    cfg.hps.batch_size = 2
    cfg.logging.logger_file = None
    cfg.metric.is_output_polygon = False
    cfg.model.widths = widths
    batch = text_batch(0, 2, 64)
    trainer = Trainer(cfg, [batch, batch], [text_batch(1, 1, 64)])
    state = trainer.resume_state(path)
    before = state.model.backbone.layer1[0].conv1.weight.detach().clone()
    assert before.shape[0] == 32
    state, history = trainer.fit(state, no_epochs=1)
    assert state.step == 2 and np.isfinite(history[0]["train_loss"])
    assert not torch.equal(state.model.backbone.layer1[0].conv1.weight,
                           before)
    last = os.path.join(str(tmp_path), cfg.model.last_cp_path)
    assert P.load_widths(last) == widths


def test_quality_bench_eval_only_on_a_pruned_checkpoint(variables,
                                                        tmp_path):
    """``quality_bench --eval_only --checkpoint <pruned>`` on a tiny set
    takes the widths from the sidecar, builds the narrow model, loads the
    pruned weights into it and evaluates every rect row."""
    from db_text_minimal_tpu_torch.cli import quality_bench as qb
    from db_text_minimal_tpu_torch.data import synthetic as syn

    syn.generate(str(tmp_path / "ds"), n_train=1, n_test=2, size=64,
                 seed=1)
    pruned, widths = P.prune_dbnet_variables(
        _sd(variables), backbone_keep=0.5, fpn_out_keep=0.5)
    ckpt = str(tmp_path / "p.pth")
    torch.save(pruned, ckpt)
    P.save_widths(ckpt, widths)
    args = qb.load_args(["--data_dir", str(tmp_path / "ds"), "--out",
                         str(tmp_path / "m.json"), "--eval_only",
                         "--checkpoint", ckpt, "--img_size", "64",
                         "--batch_size", "1", "--test_batch_size", "1",
                         "--device", "cpu"])
    assert qb.build_cfg(args).model.widths == widths
    report = qb.main(args)
    assert report["config"]["eval_only"] and report["config"]["checkpoint"]
    for row in ("host", "device"):
        for proto in ("iou_pascal", "deteval"):
            assert 0 <= report["results"][row][proto]["hmean"] <= 1
