"""The port's recognizer (``models/recognition``) against the JAX package's:
the same Flax variables, carried by ``weights.rec_state_dict_from_jax``, go
through each stage of both, at small widths, with seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from db_text_minimal_tpu.models import recognition as jrec
from db_text_minimal_tpu_torch.models import recognition as prec
from db_text_minimal_tpu_torch.weights import rec_state_dict_from_jax
from torch_rec import (ATOL, CHARSET, SMALL, crops, jax_apply, jax_init,
                       port_apply, rec_pair, smooth_crops)

torch.set_num_threads(1)


def _carry(module: torch.nn.Module, top: str, variables) -> torch.nn.Module:
    """Load a stage's flax variables, as the subtree ``top`` of a whole
    model, into the port's stage module."""
    sd = rec_state_dict_from_jax({top: variables["params"]},
                                 {top: variables.get("batch_stats", {})})
    module.load_state_dict({k[len(top) + 1:]: v for k, v in sd.items()},
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("name", ["VGG", "RCNN", "ResNet"])
def test_extractor_matches_jax(name):
    x = crops(2, seed=3)
    jm = jrec.EXTRACTORS[name](output_channel=32)
    v = jax_init(jm, jnp.asarray(x), train=False)
    ref = np.asarray(jax_apply(jm, v, x, train=False))        # NHWC
    pm = _carry(prec.EXTRACTORS[name](32), "feature_extraction", v)
    got = port_apply(pm, x.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_grid_sample_matches_jax_outside_the_image():
    rs = np.random.RandomState(4)
    img = rs.rand(2, 9, 13, 3).astype(np.float32)
    grid = rs.uniform(-1.6, 1.6, (2, 7, 11, 2)).astype(np.float32)
    ref = np.asarray(jrec._grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    got = torch.nn.functional.grid_sample(
        torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(grid),
        mode="bilinear", padding_mode="zeros", align_corners=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-6)


def _tps_variables(x):
    """TPS variables whose random fc2 moves the fiducials off the identity,
    so the sampling grid reaches outside [-1, 1]."""
    jm = jrec.TPSTransformation(20)
    v = jax_init(jm, jnp.asarray(x), train=False)
    pm = _carry(prec.TPSTransformation(20), "transformation", v)
    return jm, v, pm


def test_tps_matches_jax():
    """On smooth crops that fade out at the border (``smooth_crops``) the
    TPS outputs agree at ATOL; the grid leaves [-1, 1]."""
    x = smooth_crops(2, seed=5)
    jm, v, pm = _tps_variables(x)
    with torch.no_grad():
        c_prime = pm.localization(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(c_prime.numpy()).max() > 1.05
    ref = np.asarray(jax_apply(jm, v, x, train=False))
    got = port_apply(pm, x.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_tps_is_as_close_to_float64_as_jax():
    """The TPS grid solve in float32 is off the float64 solve by ~1.4e-5 in
    [-1, 1] units (~7e-4 pixels across 100) in both packages, each in its
    own summation order, so on a noise crop (a step of up to 2 per pixel)
    the two sampled crops differ by up to ~1e-3. Each is held to the
    float64 evaluation of the same formula on the same fiducials: the
    port's error is no larger than JAX's (1.5x) and under 2e-3."""
    x = crops(2, seed=5)
    jm, v, pm = _tps_variables(x)
    ref = np.asarray(jax_apply(jm, v, x, train=False))
    got = port_apply(pm, x.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)
    with torch.no_grad():
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        c_prime = pm.localization(xt).double()
        ctrl = jrec._base_fiducials(20)
        ys, xs = np.meshgrid(np.linspace(-1, 1, 32), np.linspace(-1, 1, 100),
                             indexing="ij")
        phat = torch.from_numpy(jrec._tps_phat(
            np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1), ctrl))
        inv = torch.from_numpy(jrec._tps_inverse_delta(ctrl))
        grid = phat @ (inv @ torch.nn.functional.pad(c_prime, (0, 0, 0, 3)))
        exact = torch.nn.functional.grid_sample(
            xt.double(), grid.reshape(2, 32, 100, 2), align_corners=True)
    exact = exact.permute(0, 2, 3, 1).numpy()
    port_err = np.abs(got - exact).max()
    jax_err = np.abs(ref - exact).max()
    assert port_err <= 1.5 * jax_err + ATOL and port_err < 2e-3, (
        port_err, jax_err)


def test_bidirectional_lstm_matches_jax():
    x = np.random.RandomState(7).randn(3, 24, 32).astype(np.float32)
    jm = jrec.BidirectionalLSTM(16, 16)
    v = jax_init(jm, jnp.asarray(x))
    ref = np.asarray(jax_apply(jm, v, x))
    pm = _carry(prec.BidirectionalLSTM(32, 16, 16), "seq1", v)
    np.testing.assert_allclose(port_apply(pm, x), ref, atol=ATOL)


def _decoder_pair(num_class=12, steps=6):
    enc = np.random.RandomState(8).randn(3, 24, 16).astype(np.float32)
    text = np.random.RandomState(9).randint(0, num_class, (3, steps + 1))
    jm = jrec.AttentionDecoder(16, num_class)
    v = jax_init(jm, jnp.asarray(enc), text=jnp.asarray(text),
                 num_steps=steps)
    pm = _carry(prec.AttentionDecoder(16, 16, num_class), "prediction", v)
    return jm, v, pm, enc, text


@pytest.mark.parametrize("teacher", [False, True])
def test_attention_decoder_matches_jax(teacher):
    jm, v, pm, enc, text = _decoder_pair()
    ref = np.asarray(jax_apply(jm, v, enc, text=jnp.asarray(text),
                               num_steps=6, train=teacher))
    pm.train(teacher)
    got = port_apply(pm, enc, text=torch.from_numpy(text), num_steps=6)
    assert got.shape == ref.shape == (3, 6, 12)
    np.testing.assert_allclose(got, ref, atol=ATOL)


class _HiddenStateDecoder(prec.AttentionDecoder):
    """The decoder as clova writes it: query and generator read h."""

    def _step(self, enc, enc_proj, h, c, token):
        e = self.score(torch.tanh(enc_proj + self.h2h(h)[:, None, :]))
        context = (torch.softmax(e, dim=1) * enc).sum(dim=1)
        onehot = torch.nn.functional.one_hot(token, self.num_class).float()
        h, c = self.rnn(torch.cat([context, onehot], dim=-1), (h, c))
        return h, c, self.generator(h)


def test_decoder_reading_the_hidden_state_differs_from_jax():
    """ROADMAP queue 3: the JAX decoder's query and generator read the LSTM
    cell state (its ``(h, c)`` unpacking of flax's ``(c, h)`` carry). The
    port keeps that; a decoder reading the hidden state, as clova's does,
    gives other logits on the same weights."""
    jm, v, pm, enc, text = _decoder_pair()
    ref = np.asarray(jax_apply(jm, v, enc, text=jnp.asarray(text),
                               num_steps=6, train=True))
    clova = _carry(_HiddenStateDecoder(16, 16, 12), "prediction", v).train()
    pm.train()
    kw = {"text": torch.from_numpy(text), "num_steps": 6}
    np.testing.assert_allclose(port_apply(pm, enc, **kw), ref, atol=ATOL)
    assert np.abs(port_apply(clova, enc, **kw) - ref).max() > 100 * ATOL


STAGES = [("None", "VGG", "None", "CTC"),
          ("None", "RCNN", "BiLSTM", "CTC"),
          ("TPS", "VGG", "BiLSTM", "Attn"),
          ("None", "ResNet", "BiLSTM", "Attn"),
          ("TPS", "ResNet", "None", "CTC")]


@pytest.mark.parametrize("stages", STAGES, ids="-".join)
def test_recognition_model_matches_jax(stages):
    trans, feat, seq, pred = stages
    num_class = 37 if pred == "CTC" else 38
    jm, v, pm = rec_pair(num_class, transformation=trans,
                         feature_extraction=feat, sequence_modeling=seq,
                         prediction=pred, **SMALL)
    # the TPS configurations on crops whose samples the float32 rounding of
    # the TPS grid cannot move (test_tps_is_as_close_to_float64_as_jax)
    x = smooth_crops(2, seed=10) if trans == "TPS" else crops(2, seed=10)
    ref = np.asarray(jax_apply(jm, v, x, train=False))
    got = port_apply(pm, x)
    t = 6 if pred == "Attn" else {"VGG": 24, "RCNN": 26, "ResNet": 24}[feat]
    assert got.shape == ref.shape == (2, t, num_class)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_train_mode_forward_and_batch_stats_match_jax():
    """Teacher-forced train-mode forward: the logits and every BN's running
    statistics after one batch, against flax's mutated ``batch_stats``."""
    jm, v, pm = rec_pair(38, transformation="TPS",
                         feature_extraction="ResNet", prediction="Attn",
                         **SMALL)
    x = smooth_crops(4, seed=11)
    text = np.random.RandomState(12).randint(0, 38, (4, 7)).astype(np.int32)
    ref, mutated = jax_apply(jm, v, x, text=jnp.asarray(text), train=True,
                             mutable=["batch_stats"])
    pm.train()
    got = port_apply(pm, x, text=torch.from_numpy(text))
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL)
    want = rec_state_dict_from_jax(v["params"],
                                   jax.device_get(mutated["batch_stats"]))
    stats = {k: t for k, t in pm.state_dict().items() if "running" in k}
    assert len(stats) == 74
    for key, value in stats.items():
        # a variance over N*H*W activations, summed in another order
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=5e-5, atol=1e-5, err_msg=key)


def test_converters_match_jax():
    words = ["hello", "a1b2", "zz", "0123456789"]
    for jc, pc in ((jrec.CTCLabelConverter, prec.CTCLabelConverter),
                   (jrec.AttnLabelConverter, prec.AttnLabelConverter)):
        j, p = jc(CHARSET), pc(CHARSET)
        assert p.character == j.character
        for got, ref in zip(p.encode(words, 12), j.encode(words, 12)):
            np.testing.assert_array_equal(got, ref)
    ctc = prec.CTCLabelConverter(CHARSET)
    enc, lens = ctc.encode(["hello"])
    seq = []
    for idx in enc[0][:5]:
        seq += [idx, idx, 0]
    assert ctc.decode(np.array(seq), [len(seq)]) == ["hello"]
    attn = prec.AttnLabelConverter(CHARSET)
    enc, lens = attn.encode(["hi"])
    assert attn.decode(enc[:, 1:], lens) == ["hi[s]"]


def test_rec_preprocess_matches_jax():
    rs = np.random.RandomState(13)
    for img in ((rs.rand(48, 180, 3) * 255).astype(np.uint8),
                (rs.rand(20, 30, 3) * 255).astype(np.uint8),
                (rs.rand(40, 90) * 255).astype(np.uint8)):
        for pad in (False, True):
            got = prec.rec_preprocess(img, pad=pad)
            assert got.shape == (1, 32, 100, 1) and got.dtype == np.float32
            np.testing.assert_array_equal(
                got, jrec.rec_preprocess(img, pad=pad))


@pytest.mark.parametrize("pred", ["CTC", "Attn"])
def test_predict_batch_matches_jax(pred):
    converter = (prec.CTCLabelConverter if pred == "CTC"
                 else prec.AttnLabelConverter)(CHARSET)
    jconv = (jrec.CTCLabelConverter if pred == "CTC"
             else jrec.AttnLabelConverter)(CHARSET)
    jm, v, pm = rec_pair(len(converter.character), feature_extraction="VGG",
                         sequence_modeling="BiLSTM", prediction=pred,
                         **SMALL)
    if pred == "Attn":   # make [s] rare, so the strings are not all empty
        v["params"]["prediction"]["generator"]["bias"][1] -= 3.0
        pm.prediction.generator.bias.data[1] -= 3.0
    x = crops(6, seed=14)
    with jax.default_matmul_precision("highest"):
        ref = jrec.predict_batch(x, jconv, jm, v, prediction=pred,
                                 batch_max_length=5)
    got = prec.predict_batch(x, converter, pm, prediction=pred,
                             batch_max_length=5)
    assert [r["pred"] for r in got] == [r["pred"] for r in ref]
    assert any(r["pred"] for r in got)
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in ref], atol=1e-5)
    single = prec.predict(x[:1], converter, pm, prediction=pred,
                          batch_max_length=5)
    assert single["pred"] == got[0]["pred"]


def test_seeded_init_follows_the_jax_distributions():
    """``reset_parameters`` draws each weight from its flax initializer's
    distribution (TPS, ResNet, BiLSTM, Attn: the fan-out and lecun convs,
    dense layers, LSTM input and recurrent kernels): per-tensor standard
    deviations within 15 % of flax's init, means near 0, the recurrent
    kernels orthogonal per gate, constants (BN, biases, fc2) equal."""
    kw = dict(transformation="TPS", feature_extraction="ResNet",
              sequence_modeling="BiLSTM", prediction="Attn", hidden_size=64,
              output_channel=128)
    jm = jrec.RecognitionModel(num_class=38, **kw)
    v = jax.device_get(jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, 32, 100, 1)), text=jnp.zeros((1, 27), jnp.int32))
    )(jax.random.PRNGKey(0)))
    want = rec_state_dict_from_jax(v["params"], v["batch_stats"])
    pm = prec.RecognitionModel(38, **kw)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    got = pm.state_dict()
    assert set(got) == set(want)
    for key, ref in want.items():
        ref, value = ref.double(), got[key].double()
        if ref.numel() < 64 or ref.std() == 0:
            np.testing.assert_allclose(value.numpy(), ref.numpy(), atol=1e-7,
                                       err_msg=key)
        else:
            assert abs(value.std() / ref.std() - 1) < 0.15, key
            assert abs(value.mean()) < 0.2 * ref.std(), key
    for key in ("prediction.rnn.weight_hh", "seq1.rnn.weight_hh_l0_reverse"):
        w = got[key][64:128].double()
        np.testing.assert_allclose((w @ w.T).numpy(), np.eye(64), atol=1e-5)
