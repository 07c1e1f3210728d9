"""The port's recognizer training (``train/recognition_trainer``,
``cli/train_rec``) and its data (``data.synthetic.generate_glyphs`` and
``export_word_crops``) against the JAX package's, on the CPU."""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from db_text_minimal_tpu.train import recognition_trainer as jtrain
from db_text_minimal_tpu_torch.train import recognition_trainer as ptrain
from db_text_minimal_tpu_torch.train.checkpoints import (load_params_any,
                                                         save_checkpoint)
from db_text_minimal_tpu_torch.weights import rec_state_dict_from_jax
from torch_rec import SMALL, crops, rec_pair

torch.set_num_threads(1)

LR = 1e-3


def _labels(pred: str, n: int, seed: int):
    """Random words of 1 to 5 characters, encoded as both packages do."""
    from db_text_minimal_tpu_torch.models.recognition import (
        AttnLabelConverter, CTCLabelConverter)

    rs = np.random.RandomState(seed)
    words = ["".join(rs.choice(list("0123456789abc"), rs.randint(1, 6)))
             for _ in range(n)]
    conv = (CTCLabelConverter if pred == "CTC"
            else AttnLabelConverter)("0123456789abcdefghijklmnopqrstuvwxyz")
    return conv.encode(words, 5)


@pytest.mark.parametrize("pred", ["CTC", "Attn"])
def test_losses_match_jax(pred):
    rs = np.random.RandomState(1)
    targets, lengths = _labels(pred, 4, seed=2)
    t, c = (24, 37) if pred == "CTC" else (6, 38)
    logits = rs.randn(4, t, c).astype(np.float32) * 2
    jloss = jtrain.ctc_loss if pred == "CTC" else jtrain.attn_loss
    ploss = ptrain.ctc_loss if pred == "CTC" else ptrain.attn_loss
    ref, ref_grad = jax.value_and_grad(jloss)(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(lengths))
    x = torch.from_numpy(logits).requires_grad_()
    got = ploss(x, torch.from_numpy(targets), torch.from_numpy(lengths))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    # the CTC forward-backward sums in log space in another order
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-4, atol=1e-6)


def test_ctc_unalignable_label_stays_finite():
    """A label that cannot be aligned in T frames (here 7 labels, or 4
    repeats needing 7 frames, in T = 6) costs ~1e5 in optax (its
    log-epsilon floor) with a bounded gradient, and the port's loss is
    optax's: the batch mean at rtol 1e-6, the alignable sequence's
    gradient at the tolerance of ``test_losses_match_jax``, and the
    unalignable ones' at atol 2^-6. Near the floor every log-space value
    is rounded to the float32 spacing at 1e5, 2^-7, and a gradient is an
    exponential of their differences, so each implementation lies ~1 %
    (0.2-0.9 % measured) from the float64 recursion; the two lie 2.9e-3
    apart at most, on gradients up to 0.28."""
    rs = np.random.RandomState(0)
    logits = rs.randn(3, 6, 5).astype(np.float32)
    labels = np.array([[1, 2, 3, 0, 0, 0, 0], [1, 1, 1, 1, 0, 0, 0],
                       [1, 2, 3, 4, 1, 2, 3]], np.int32)
    lengths = np.array([3, 4, 7], np.int32)
    pad = (np.arange(7)[None] >= lengths[:, None]).astype(np.float32)
    per_seq = np.asarray(optax.ctc_loss(jnp.asarray(logits),
                                        jnp.zeros((3, 6)),
                                        jnp.asarray(labels), pad))
    assert (per_seq[1:] > 1e4).all()
    ref_grad = np.asarray(jax.grad(jtrain.ctc_loss)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(lengths)))
    assert np.isfinite(ref_grad).all() and np.abs(ref_grad[1:]).max() > 0.1

    x = torch.from_numpy(logits).requires_grad_()
    loss = ptrain.ctc_loss(x, torch.from_numpy(labels),
                           torch.from_numpy(lengths))
    loss.backward()
    np.testing.assert_allclose(loss.item(), per_seq.mean(), rtol=1e-6)
    np.testing.assert_allclose(x.grad[0].numpy(), ref_grad[0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(x.grad[1:].numpy(), ref_grad[1:], rtol=0,
                               atol=2.0 ** -6)
    assert np.abs(x.grad[1:].numpy()).max() > 0.1

    # a whole step on an unalignable batch leaves finite weights
    _, _, model = rec_pair(37, feature_extraction="VGG",
                           sequence_modeling="None", prediction="CTC",
                           **SMALL)
    state = ptrain.RecTrainState(model, torch.optim.Adam(
        [p for p in model.parameters() if p.requires_grad]))
    step = ptrain.build_rec_train_step(state)
    # 25 labels in the 24 frames of VGG, and one of 3
    long = np.tile(np.arange(25, dtype=np.int32) % 10 + 1, (2, 1))
    loss = step(torch.from_numpy(crops(2)), torch.from_numpy(long),
                torch.tensor([25, 3]), LR)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p).all() for p in model.parameters())


def _weights(model_or_sd):
    """(name, tensor) of the weights and BN statistics, without torch's
    own ``num_batches_tracked`` counters."""
    sd = (model_or_sd.state_dict() if isinstance(model_or_sd, torch.nn.Module)
          else model_or_sd)
    return [(k, v) for k, v in sd.items()
            if not k.endswith("num_batches_tracked")]


def _jax_state(jm, v):
    tx = optax.scale_by_adam()
    return tx, jtrain.RecTrainState(
        params=v["params"], batch_stats=v["batch_stats"],
        opt_state=tx.init(v["params"]), step=jnp.zeros((), jnp.int32))


def _port_state(pm):
    return ptrain.RecTrainState(pm, torch.optim.Adam(
        [p for p in pm.parameters() if p.requires_grad], lr=0.0,
        betas=(0.9, 0.999), eps=1e-8))


def _pair(pred):
    return rec_pair(37 if pred == "CTC" else 38, feature_extraction="VGG",
                    sequence_modeling="BiLSTM", prediction=pred, **SMALL)


@pytest.mark.parametrize("pred", ["CTC", "Attn"])
def test_train_step_matches_jax(pred):
    """One step from the same carried weights: the loss, every gradient,
    the BN running statistics and the Adam-updated weights."""
    jm, v, pm = _pair(pred)
    tx, jstate = _jax_state(jm, v)
    x = crops(4, seed=3)
    targets, lengths = _labels(pred, 4, seed=4)
    args = (jnp.asarray(x), jnp.asarray(targets), jnp.asarray(lengths))

    def loss_fn(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, args[0],
                            text=args[1] if pred == "Attn" else None,
                            train=True, mutable=["batch_stats"])
        loss = (jtrain.ctc_loss if pred == "CTC" else jtrain.attn_loss)(
            out, args[1], args[2])
        return loss, mut

    with jax.default_matmul_precision("highest"):
        grads = jax.jit(jax.grad(lambda p: loss_fn(p)[0]))(v["params"])
        new, ref_loss = jax.jit(jtrain.build_rec_train_step(jm, tx))(
            jstate, *args, jnp.float32(LR))
    new = jax.device_get(new)

    pm.train()
    state = _port_state(pm)
    loss = ptrain.build_rec_train_step(state)(
        torch.from_numpy(x), torch.from_numpy(targets),
        torch.from_numpy(lengths), LR)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    want_grads = rec_state_dict_from_jax(jax.device_get(grads), {})
    for name, p in pm.named_parameters():
        if not p.requires_grad:        # bias_ih: zero and frozen
            assert (p == 0).all() and p.grad is None, name
            continue
        scale = float(want_grads[name].abs().max()) + 1e-6
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   atol=1e-4 * scale, err_msg=name)
    want = rec_state_dict_from_jax(new.params, new.batch_stats)
    for name, value in _weights(pm):
        # Adam's first step moves each weight by lr * g / (|g| + eps): a
        # gradient of float-noise size may flip its sign, so the weights
        # agree to 2 lr where they could, and to 1e-5 almost everywhere
        diff = np.abs(value.numpy() - want[name].numpy())
        assert diff.max() <= 2 * LR + 1e-6, name
        assert (diff > 1e-5).mean() < 0.01, name
    assert state.step == 1


@pytest.mark.parametrize("pred", ["CTC", "Attn"])
def test_chain_step_matches_jax_and_sequential_steps(pred):
    """K = 3 steps of uint8 batches in one call: equal, bit for bit, to
    three single steps of the port, and to JAX's chained step within
    Adam's amplification of float noise (JAX's own chain-against-
    sequential tolerances, test_recognition_training.py)."""
    jm, v, pm = _pair(pred)
    tx, jstate = _jax_state(jm, v)
    rs = np.random.RandomState(5)
    u8 = rs.randint(0, 256, (3, 2, 32, 100, 1)).astype(np.uint8)
    tl = [_labels(pred, 2, seed=10 + k) for k in range(3)]
    targets = np.stack([t for t, _ in tl])
    lengths = np.stack([ln for _, ln in tl])
    with jax.default_matmul_precision("highest"):
        jnew, jlosses = jax.jit(jtrain.build_rec_chain_step(jm, tx))(
            jstate, jnp.asarray(u8), jnp.asarray(targets),
            jnp.asarray(lengths), jnp.float32(LR))

    seq = _pair(pred)[2]
    seq_state = _port_state(seq)
    step = ptrain.build_rec_train_step(seq_state)
    seq_losses = [step(torch.from_numpy(u8[k]).float() / 127.5 - 1.0,
                       torch.from_numpy(targets[k]),
                       torch.from_numpy(lengths[k]), LR) for k in range(3)]
    state = _port_state(pm)
    losses = ptrain.build_rec_chain_step(state)(
        torch.from_numpy(u8), torch.from_numpy(targets),
        torch.from_numpy(lengths), LR)
    assert torch.equal(losses, torch.stack(seq_losses))
    for a, b in zip(pm.state_dict().values(), seq.state_dict().values()):
        assert torch.equal(a, b)

    np.testing.assert_allclose(losses[0].item(), float(jlosses[0]),
                               rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-3)
    want = rec_state_dict_from_jax(*jax.device_get(
        (jnew.params, jnew.batch_stats)))
    for name, value in _weights(pm):
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=1e-2, atol=5e-4, err_msg=name)


def test_generate_glyphs_matches_jax(tmp_path):
    """The glyph set through the live text engine (cv2's): the same
    images and GT files as the JAX package's for a seed."""
    from db_text_minimal_tpu.data.synthetic import generate_glyphs as jgen
    from db_text_minimal_tpu_torch.data.synthetic import generate_glyphs

    a = jgen(str(tmp_path / "jax"), n_train=3, n_test=2, size=256, seed=3)
    b = generate_glyphs(str(tmp_path / "port"), n_train=3, n_test=2,
                        size=256, seed=3)
    for key in ("train_dir", "test_dir", "train_gt_dir", "test_gt_dir"):
        names = sorted(os.listdir(a[key]))
        assert names and names == sorted(os.listdir(b[key]))
        match, mismatch, errors = filecmp.cmpfiles(a[key], b[key], names,
                                                   shallow=False)
        assert not mismatch and not errors, (key, mismatch)
    assert b["ignore_tags"] == ["###"]


def test_export_word_crops_matches_jax(tmp_path):
    """``labels.txt`` and every crop equal to the JAX package's on one
    glyph set with a curved 14-point and an ignore-tagged word added to a
    GT file (the min-area-rect rectification and the skip)."""
    from db_text_minimal_tpu.data.synthetic import \
        export_word_crops as jexport
    from db_text_minimal_tpu_torch.data.synthetic import (export_word_crops,
                                                          generate_glyphs)

    section = generate_glyphs(str(tmp_path / "g"), n_train=2, n_test=1,
                              size=256, seed=4)
    curve = np.array([[20 + 20 * i, 200 + 8 * np.sin(i)] for i in range(7)]
                     + [[140 - 20 * i, 225 + 8 * np.sin(6 - i)]
                        for i in range(7)])
    with open(os.path.join(section["train_gt_dir"], "gt_img0.txt"),
              "a") as f:
        f.write(",".join(f"{v:.1f}" for v in curve.reshape(-1)) + ",bend\n")
        f.write("5.0,5.0,40.0,5.0,40.0,20.0,5.0,20.0,###\n")
    jexport(section, str(tmp_path / "jax"))
    export_word_crops(section, str(tmp_path / "port"))
    with open(tmp_path / "port" / "labels.txt") as f:
        labels = f.read()
    with open(tmp_path / "jax" / "labels.txt") as f:
        assert labels == f.read()
    assert "\tbend\n" in labels and "###" not in labels
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) > 8 and names == sorted(os.listdir(tmp_path / "port"))
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", names, shallow=False)
    assert not mismatch and not errors


@pytest.fixture(scope="module")
def crop_dir(tmp_path_factory):
    from db_text_minimal_tpu_torch.data.synthetic import (export_word_crops,
                                                          generate_glyphs)

    root = tmp_path_factory.mktemp("train_rec")
    section = generate_glyphs(str(root / "g"), n_train=2, n_test=1,
                              size=256, seed=6)
    return export_word_crops(section, str(root / "crops"), jitter_copies=1)


SMALL_FLAGS = ["--FeatureExtraction", "VGG", "--SequenceModeling", "None",
               "--Prediction", "CTC", "--output_channel", "32",
               "--hidden_size", "16", "--batch_size", "3"]


def test_train_rec_cli_matches_jax(crop_dir, tmp_path):
    """``cli.train_rec`` against JAX's: the JAX CLI's initial weights
    (``--epochs 0``) carried into the port by ``--init_from``, then one
    epoch in both. The sidecars have the same keys, the batches come in
    the same order (the losses agree), the trained weights agree within
    Adam's amplification of float noise, and ``--steps_per_call`` 1 and 2
    train the port to the same weights bit for bit."""
    from db_text_minimal_tpu.cli import train_rec as jcli
    from db_text_minimal_tpu.train.checkpoints import \
        load_params_any as jload
    from db_text_minimal_tpu_torch.cli import train_rec

    def jax_run(name, epochs):
        out = str(tmp_path / name)
        _, loss = jcli.main(jcli.load_args(
            ["--crop_dir", crop_dir, "--out", out, "--epochs", str(epochs),
             "--steps_per_call", "2"] + SMALL_FLAGS))
        return out, loss

    init, _ = jax_run("jax0.ckpt", 0)
    trained, jax_loss = jax_run("jax1.ckpt", 1)
    carried = str(tmp_path / "init.ckpt")
    v = jload(init)
    save_checkpoint(carried, {"model": rec_state_dict_from_jax(
        v["params"], v["batch_stats"])})

    runs = {}
    for spc in ("1", "2"):
        out = str(tmp_path / f"port{spc}.ckpt")
        _, runs[spc] = train_rec.main(train_rec.load_args(
            ["--crop_dir", crop_dir, "--out", out, "--epochs", "1",
             "--steps_per_call", spc, "--init_from", carried,
             "--device", "cpu"] + SMALL_FLAGS))
    one, two = (load_params_any(str(tmp_path / f"port{s}.ckpt"))
                for s in ("1", "2"))
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert runs["1"] == runs["2"]
    np.testing.assert_allclose(runs["1"], jax_loss, rtol=1e-3)

    with open(trained + ".json") as f:
        jmeta = json.load(f)
    with open(tmp_path / "port1.ckpt.json") as f:
        meta = json.load(f)
    assert set(meta) == set(jmeta)
    assert meta["init_from"] == carried and jmeta["init_from"] is None
    for key in set(meta) - {"init_from", "loss"}:
        assert meta[key] == jmeta[key], key

    jv = jload(trained)
    want = rec_state_dict_from_jax(jv["params"], jv["batch_stats"])
    for name, value in _weights(one):
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=1e-2, atol=5e-4, err_msg=name)


def test_train_rec_cli_seeded_start(crop_dir, tmp_path):
    """Without ``--init_from`` the CLI starts from its seeded init: the
    same seed gives the same checkpoint, and its keys are the model's."""
    from db_text_minimal_tpu_torch.cli import train_rec

    outs = []
    for name in ("a.ckpt", "b.ckpt"):
        out = str(tmp_path / name)
        train_rec.main(train_rec.load_args(
            ["--crop_dir", crop_dir, "--out", out, "--epochs", "1",
             "--device", "cpu"] + SMALL_FLAGS))
        outs.append(load_params_any(out))
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    # load_params_any drops the detector's unused modules only
    from db_text_minimal_tpu_torch.models.recognition import \
        RecognitionModel

    model = RecognitionModel(37, feature_extraction="VGG",
                             sequence_modeling="None", prediction="CTC",
                             output_channel=32, hidden_size=16)
    assert set(outs[0]) == set(model.state_dict())
    ckpt = torch.load(str(tmp_path / "a.ckpt"), weights_only=True)
    assert set(ckpt) == {"model", "optimizer", "step"} and ckpt["step"] > 0
