"""Scene-text recognition: the four-stage recognizer, its label converters,
preprocessing and greedy decoding.

Counterpart of ``db_text_minimal_tpu/models/recognition.py``: Transformation
None|TPS, FeatureExtraction VGG|RCNN|ResNet, SequenceModeling None|BiLSTM,
Prediction CTC|Attn, one ``nn.Module`` per JAX class, with the state_dict
names that ``weights.rec_state_dict_from_jax`` writes. The public layout is
the JAX package's: ``RecognitionModel`` takes (N, 32, 100, 1) NHWC crops
normalized to [-1, 1] (``rec_preprocess``) and returns logits
(N, T, num_class); modules work in NCHW inside. Train or eval mode is the
module's ``training`` flag (flax's ``train`` argument).

- Batch norm is ``layers.BatchNorm2d`` (flax's momentum and biased
  running variance).
- ``compute_dtype`` is flax's ``dtype``: the convs of the TPS localization
  network and of the extractor compute in it; BN, the TPS solve and
  sampler, the LSTMs and the heads compute in float32, as in JAX.
- TPS samples with ``F.grid_sample(align_corners=True,
  padding_mode="zeros")``, the JAX gather-form ``_grid_sample``.
- ``AttentionDecoder`` keeps the JAX decoder's carry: JAX unpacks flax's
  ``(c, h)`` LSTM carry as ``(h, c)``, so the attention query and the
  generator read the LSTM's **cell state**, not its hidden state (clova
  reads the hidden state; ROADMAP queue 3 records the deviation).
- Each LSTM keeps torch's two biases, but only ``bias_hh`` (flax's one
  bias) trains: ``bias_ih`` is zero and frozen, since both get the same
  gradient and two trained copies would move the sum twice as far.
- ``reset_parameters(generator)`` draws every weight from the JAX module's
  distribution: the fan-out truncated normal of ``he_normal_torch`` where
  JAX names it (``_conv_bn_relu`` and the localization convs), flax's
  lecun-normal for the other convs and every dense and LSTM input kernel,
  orthogonal LSTM recurrent kernels, zero biases, and the localization
  network's last layer at the identity fiducials.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, batch_norm

# flax's truncated normal is cut at two standard deviations and rescaled by
# this constant so the drawn values keep the asked-for variance
_TRUNC_STD = 0.87962566103423978


def _variance_scaling(weight: torch.Tensor, fan: int, scale: float,
                      generator: torch.Generator) -> None:
    std = math.sqrt(scale / fan) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class ConvBnRelu(nn.Module):
    """JAX ``_conv_bn_relu``: a bias-free conv, BN, then relu when
    ``relu`` (the residual blocks' second conv and shortcut stop at BN).
    ``he_init`` marks the convs JAX draws from ``he_normal_torch``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride=(1, 1),
                 pad: int = 1, relu: bool = True, he_init: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                           bias=False)
        self.conv.he_init = he_init
        self.bn = batch_norm(cout)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


def _pool2(x):
    return F.max_pool2d(x, (2, 2), (2, 2))


def _pool_h2(x):
    return F.max_pool2d(x, (2, 1), (2, 1))


def _pool_h2_pad_w(x):
    # flax max_pool (2, 2), strides (2, 1), padding [(0, 0), (1, 1)]
    return F.max_pool2d(x, (2, 2), (2, 1), padding=(0, 1))


# ---------------------------------------------------------------------------
# Stage 1: Transformation (TPS spatial transformer)
# ---------------------------------------------------------------------------

def _base_fiducials(f: int) -> np.ndarray:
    """F control points on the top/bottom edges in [-1, 1] coords."""
    half = f // 2
    x = np.linspace(-1.0, 1.0, half)
    top = np.stack([x, -np.ones(half)], axis=1)
    bottom = np.stack([x, np.ones(half)], axis=1)
    return np.concatenate([top, bottom], axis=0)  # (F, 2)


def _tps_inverse_delta(ctrl: np.ndarray) -> np.ndarray:
    f = ctrl.shape[0]
    d2 = ((ctrl[:, None, :] - ctrl[None, :, :]) ** 2).sum(-1)
    u = d2 * np.log(d2 + np.eye(f))  # U(r) = r^2 log r^2; diag zero
    delta = np.zeros((f + 3, f + 3))
    delta[:f, 0] = 1.0
    delta[:f, 1:3] = ctrl
    delta[:f, 3:] = u
    delta[f, 3:] = 1.0
    delta[f + 1:, 3:] = ctrl.T
    return np.linalg.inv(delta)


def _tps_phat(points: np.ndarray, ctrl: np.ndarray) -> np.ndarray:
    n = points.shape[0]
    d2 = ((points[:, None, :] - ctrl[None, :, :]) ** 2).sum(-1)
    rbf = d2 * np.log(d2 + 1e-9)
    return np.concatenate([np.ones((n, 1)), points, rbf], axis=1)


class LocalizationNetwork(nn.Module):
    """Predicts F fiducial points (N, F, 2) from the NCHW input crop."""

    def __init__(self, num_fiducial: int = 20, in_channels: int = 1):
        super().__init__()
        self.num_fiducial = num_fiducial
        chans = (in_channels, 64, 128, 256, 512)
        self.blocks = nn.ModuleList(
            ConvBnRelu(chans[i], chans[i + 1]) for i in range(4))
        self.fc1 = nn.Linear(512, 256)
        self.fc2 = nn.Linear(256, num_fiducial * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i < 3:
                x = _pool2(x)
        x = F.relu(self.fc1(x.float().mean(dim=(2, 3))))
        return self.fc2(x).reshape(-1, self.num_fiducial, 2)

    def reset_fiducials(self) -> None:
        """fc2 at zero weight and the base fiducials as bias, so the
        network starts at the identity transform."""
        with torch.no_grad():
            self.fc2.weight.zero_()
            self.fc2.bias.copy_(torch.from_numpy(
                _base_fiducials(self.num_fiducial).reshape(-1)))


class TPSTransformation(nn.Module):
    """TPS spatial transformer: rectifies curved text to an axis-aligned
    crop of the input's size. The grid solve uses the static inverse-delta
    and P-hat matrices (float64 numpy, used in float32, P-hat made once per
    input size and device); the per-image work is one (F+3)x2 solve and a
    bilinear sample."""

    def __init__(self, num_fiducial: int = 20, in_channels: int = 1):
        super().__init__()
        self.ctrl = _base_fiducials(num_fiducial)
        self.register_buffer("inv_delta", torch.from_numpy(
            _tps_inverse_delta(self.ctrl)).float(), persistent=False)
        self._phat: dict = {}
        self.localization = LocalizationNetwork(num_fiducial, in_channels)

    def phat(self, oh: int, ow: int, device) -> torch.Tensor:
        key = (oh, ow, str(device))
        if key not in self._phat:
            ys, xs = np.meshgrid(np.linspace(-1, 1, oh),
                                 np.linspace(-1, 1, ow), indexing="ij")
            grid = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1)
            self._phat[key] = torch.from_numpy(
                _tps_phat(grid, self.ctrl)).float().to(device)
        return self._phat[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        oh, ow = x.shape[2:]
        c_prime = self.localization(x)
        rhs = F.pad(c_prime, (0, 0, 0, 3))                 # (N, F+3, 2)
        t = torch.matmul(self.inv_delta, rhs)              # (N, F+3, 2)
        sample = torch.matmul(self.phat(oh, ow, x.device), t)  # (N, HW, 2)
        return F.grid_sample(x.float(), sample.reshape(-1, oh, ow, 2),
                             mode="bilinear", padding_mode="zeros",
                             align_corners=True)


# ---------------------------------------------------------------------------
# Stage 2: Feature extraction (VGG / RCNN / ResNet) -> (N, C, 1, W')
# ---------------------------------------------------------------------------

class VGGExtractor(nn.Module):
    """CRNN-style VGG: (N, 1, 32, 100) -> (N, C, 1, 24)."""

    def __init__(self, output_channel: int = 512, in_channels: int = 1):
        super().__init__()
        oc = output_channel
        c = (oc // 8, oc // 4, oc // 2, oc)
        self.l0 = ConvBnRelu(in_channels, c[0])
        self.l1 = ConvBnRelu(c[0], c[1])
        self.l2 = ConvBnRelu(c[1], c[2])
        self.l3 = ConvBnRelu(c[2], c[2])
        self.l4 = ConvBnRelu(c[2], c[3])
        self.l5 = ConvBnRelu(c[3], c[3])
        self.l6 = ConvBnRelu(c[3], c[3], kernel=2, pad=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pool2(self.l0(x))                              # 16x50
        x = _pool2(self.l1(x))                              # 8x25
        x = _pool_h2(self.l3(self.l2(x)))                   # 4x25
        x = _pool_h2(self.l5(self.l4(x)))                   # 2x25
        return self.l6(x)                                   # 1x24


class GRCL(nn.Module):
    """Gated recurrent conv layer (RCNN extractor building block)."""

    def __init__(self, cin: int, channels: int, iterations: int = 5):
        super().__init__()
        self.iterations = iterations
        self.wgf = Conv2d(cin, channels, 1, bias=False)
        self.wgr = Conv2d(channels, channels, 1, bias=False)
        self.wf = Conv2d(cin, channels, 3, padding=1, bias=False)
        self.wr = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn_f = batch_norm(channels)
        for name in ("bn_gf", "bn_gr", "bn_x", "bn_h"):
            setattr(self, name, nn.ModuleList(
                batch_norm(channels) for _ in range(iterations)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wgf_x = self.wgf(x)
        wf_x = self.wf(x)
        h = F.relu(self.bn_f(wf_x))
        for it in range(self.iterations):
            gate = torch.sigmoid(self.bn_gf[it](wgf_x)
                                 + self.bn_gr[it](self.wgr(h)))
            h = F.relu(self.bn_x[it](wf_x) + self.bn_h[it](self.wr(h)) * gate)
        return h


class RCNNExtractor(nn.Module):
    """GRCL-based extractor -> (N, C, 1, 26)."""

    def __init__(self, output_channel: int = 512, in_channels: int = 1):
        super().__init__()
        oc = output_channel
        self.stem = ConvBnRelu(in_channels, oc // 8)
        self.grcl1 = GRCL(oc // 8, oc // 8)
        self.up2 = ConvBnRelu(oc // 8, oc // 4, kernel=1, pad=0)
        self.grcl2 = GRCL(oc // 4, oc // 4)
        self.up3 = ConvBnRelu(oc // 4, oc // 2, kernel=1, pad=0)
        self.grcl3 = GRCL(oc // 2, oc // 2)
        self.head = ConvBnRelu(oc // 2, oc, kernel=2, stride=(2, 1), pad=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pool2(self.stem(x))                            # 16x50
        x = _pool2(self.grcl1(x))                           # 8x25
        x = _pool_h2_pad_w(self.grcl2(self.up2(x)))         # 4x26
        x = _pool_h2_pad_w(self.grcl3(self.up3(x)))         # 2x27
        return self.head(x)                                 # 1x26


class _RecBasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, downsample: bool = False):
        super().__init__()
        self.c1 = ConvBnRelu(inplanes, planes)
        self.c2 = ConvBnRelu(planes, planes, relu=False, he_init=False)
        self.down = (ConvBnRelu(inplanes, planes, kernel=1, pad=0,
                                relu=False, he_init=False)
                     if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.down is None else self.down(x)
        return F.relu(self.c2(self.c1(x)) + residual)


def _blocks(inplanes: int, planes: int, count: int) -> nn.ModuleList:
    return nn.ModuleList(
        _RecBasicBlock(inplanes if i == 0 else planes, planes,
                       downsample=i == 0) for i in range(count))


class ResNetExtractor(nn.Module):
    """clova-style recognition ResNet -> (N, C, 1, 24)."""

    def __init__(self, output_channel: int = 512, in_channels: int = 1):
        super().__init__()
        oc = output_channel
        self.c0_1 = ConvBnRelu(in_channels, oc // 16)
        self.c0_2 = ConvBnRelu(oc // 16, oc // 8)
        self.b1 = _blocks(oc // 8, oc // 4, 1)
        self.c1 = ConvBnRelu(oc // 4, oc // 4)
        self.b2 = _blocks(oc // 4, oc // 2, 2)
        self.c2 = ConvBnRelu(oc // 2, oc // 2)
        self.b3 = _blocks(oc // 2, oc, 5)
        self.c3 = ConvBnRelu(oc, oc)
        self.b4 = _blocks(oc, oc, 3)
        self.c4_1 = ConvBnRelu(oc, oc, kernel=2, stride=(2, 1), pad=0)
        self.c4_2 = ConvBnRelu(oc, oc, kernel=2, stride=(2, 1), pad=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _pool2(self.c0_2(self.c0_1(x)))                 # 16x50
        for block in self.b1:
            x = block(x)
        x = _pool2(self.c1(x))                              # 8x25
        for block in self.b2:
            x = block(x)
        x = _pool_h2_pad_w(self.c2(x))                      # 4x26
        for block in self.b3:
            x = block(x)
        x = self.c3(x)
        for block in self.b4:
            x = block(x)
        return self.c4_2(self.c4_1(x))                      # 2x25, 1x24


EXTRACTORS = {"VGG": VGGExtractor, "RCNN": RCNNExtractor,
              "ResNet": ResNetExtractor}


# ---------------------------------------------------------------------------
# Stage 3: Sequence modeling (BiLSTM)
# ---------------------------------------------------------------------------

def _one_bias(rnn: nn.Module) -> nn.Module:
    """Zero and freeze the input-side biases: flax's cell has one bias per
    gate, which ``bias_hh`` holds."""
    for name, param in rnn.named_parameters():
        if name.startswith("bias_ih"):
            nn.init.zeros_(param)
            param.requires_grad_(False)
    return rnn


class BidirectionalLSTM(nn.Module):
    """(N, T, in) -> (N, T, out): a bidirectional LSTM, then a linear
    projection of both directions' hidden states."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int):
        super().__init__()
        self.rnn = _one_bias(nn.LSTM(in_size, hidden_size, batch_first=True,
                                     bidirectional=True))
        self.proj = nn.Linear(2 * hidden_size, out_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.rnn(x)[0])


# ---------------------------------------------------------------------------
# Stage 4: Prediction (CTC / attention decoder)
# ---------------------------------------------------------------------------

class AttentionDecoder(nn.Module):
    """Bahdanau-style LSTM attention decoder over ``num_steps`` steps:
    teacher forcing on ``text`` in train mode, greedy decode from [GO]
    otherwise. The query and the generator read the LSTM's cell state, as
    the JAX decoder does (see the module)."""

    def __init__(self, in_size: int, hidden_size: int, num_class: int):
        super().__init__()
        self.num_class = num_class
        self.rnn = _one_bias(nn.LSTMCell(in_size + num_class, hidden_size))
        self.i2h = nn.Linear(in_size, hidden_size, bias=False)
        self.h2h = nn.Linear(hidden_size, hidden_size)
        self.score = nn.Linear(hidden_size, 1, bias=False)
        self.generator = nn.Linear(hidden_size, num_class)

    def _step(self, enc, enc_proj, h, c, token):
        e = self.score(torch.tanh(enc_proj + self.h2h(c)[:, None, :]))
        alpha = torch.softmax(e, dim=1)                      # (N, T, 1)
        context = (alpha * enc).sum(dim=1)                   # (N, C)
        onehot = F.one_hot(token, self.num_class).to(enc.dtype)
        h, c = self.rnn(torch.cat([context, onehot], dim=-1), (h, c))
        return h, c, self.generator(c)

    def forward(self, enc: torch.Tensor, text: torch.Tensor | None = None,
                num_steps: int = 26) -> torch.Tensor:
        n = enc.shape[0]
        enc_proj = self.i2h(enc)                             # (N, T, H)
        h = c = enc.new_zeros(n, self.rnn.hidden_size)
        teacher = self.training and text is not None
        token = torch.zeros(n, dtype=torch.long, device=enc.device)  # [GO]
        all_logits = []
        for t in range(num_steps):
            if teacher:
                token = text[:, t].long()
            h, c, logits = self._step(enc, enc_proj, h, c, token)
            all_logits.append(logits)
            if not teacher:
                token = logits.argmax(dim=-1)
        return torch.stack(all_logits, dim=1)


# ---------------------------------------------------------------------------
# Four-stage model
# ---------------------------------------------------------------------------

class RecognitionModel(nn.Module):
    """clova ``Model(opt)`` equivalent: NHWC (N, H, W, C) crops in,
    (N, T, num_class) logits out."""

    def __init__(self, num_class: int, transformation: str = "None",
                 feature_extraction: str = "ResNet",
                 sequence_modeling: str = "BiLSTM",
                 prediction: str = "Attn", hidden_size: int = 256,
                 output_channel: int = 512, num_fiducial: int = 20,
                 batch_max_length: int = 25,
                 compute_dtype: torch.dtype = torch.float32,
                 input_channel: int = 1):
        super().__init__()
        self.prediction_name = prediction
        self.batch_max_length = batch_max_length
        self.transformation = (TPSTransformation(num_fiducial,
                                                 input_channel)
                               if transformation == "TPS" else None)
        self.feature_extraction = EXTRACTORS[feature_extraction](
            output_channel, input_channel)
        feat = output_channel
        if sequence_modeling == "BiLSTM":
            self.seq1 = BidirectionalLSTM(feat, hidden_size, hidden_size)
            self.seq2 = BidirectionalLSTM(hidden_size, hidden_size,
                                          hidden_size)
            feat = hidden_size
        else:
            self.seq1 = self.seq2 = None
        self.prediction = (nn.Linear(feat, num_class) if prediction == "CTC"
                           else AttentionDecoder(feat, hidden_size,
                                                 num_class))
        self.set_compute_dtype(compute_dtype)

    def set_compute_dtype(self, dtype: torch.dtype) -> "RecognitionModel":
        """Run the convs in ``dtype`` (float32 or bfloat16) from now on."""
        self.compute_dtype = dtype
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.compute_dtype = dtype
        return self

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded weights from the JAX module's distributions (see the
        module)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    o, i, kh, kw = m.weight.shape
                    if getattr(m, "he_init", False):
                        _variance_scaling(m.weight, o * kh * kw, 2.0,
                                          generator)
                    else:
                        _variance_scaling(m.weight, i * kh * kw, 1.0,
                                          generator)
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
                elif isinstance(m, nn.Linear):
                    _variance_scaling(m.weight, m.in_features, 1.0,
                                      generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (nn.LSTM, nn.LSTMCell)):
                    _reset_lstm(m, generator)
            if self.transformation is not None:
                self.transformation.localization.reset_fiducials()

    def flatten_parameters(self) -> "RecognitionModel":
        """Lay the LSTMs' weights out as cuDNN wants them after a load or a
        move (otherwise cuDNN copies them at every call)."""
        for m in self.modules():
            if isinstance(m, nn.LSTM):
                m.flatten_parameters()
        return self

    def forward(self, x: torch.Tensor,
                text: torch.Tensor | None = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.transformation is not None:
            x = self.transformation(x)
        feat = self.feature_extraction(x)
        # (N, C, 1, W') -> (N, W', C): adaptive pool over the height
        feat = feat.float().mean(dim=2).transpose(1, 2)
        if self.seq1 is not None:
            feat = self.seq2(self.seq1(feat))
        if self.prediction_name == "CTC":
            return self.prediction(feat)
        return self.prediction(feat, text=text,
                               num_steps=self.batch_max_length + 1)


def _reset_lstm(m: nn.Module, generator: torch.Generator) -> None:
    """flax ``OptimizedLSTMCell``'s init: lecun-normal input kernels, an
    orthogonal recurrent kernel per gate, zero biases."""
    hidden = m.hidden_size
    for name, param in m.named_parameters():
        if name.startswith("weight_ih"):
            _variance_scaling(param, param.shape[1], 1.0, generator)
        elif name.startswith("weight_hh"):
            for g in range(4):
                block = torch.empty(hidden, hidden)
                nn.init.orthogonal_(block, generator=generator)
                param[g * hidden:(g + 1) * hidden].copy_(block.T)
        else:
            param.zero_()


# ---------------------------------------------------------------------------
# Label converters + preprocessing (clova_ocr.utils / dataset equivalents)
# ---------------------------------------------------------------------------

class CTCLabelConverter:
    """blank at index 0; characters from index 1."""

    def __init__(self, character: str):
        self.character = ["[CTCblank]"] + list(character)
        self.dict = {c: i + 1 for i, c in enumerate(character)}

    def encode(self, texts, batch_max_length: int = 25):
        lengths = [len(t) for t in texts]
        out = np.zeros((len(texts), batch_max_length), np.int32)
        for i, t in enumerate(texts):
            out[i, :len(t)] = [self.dict[c] for c in t]
        return out, np.array(lengths, np.int32)

    def decode(self, indices, lengths):
        texts = []
        index = 0
        for length in lengths:
            t = indices[index:index + length]
            chars = []
            for i in range(length):
                if t[i] != 0 and (not (i > 0 and t[i - 1] == t[i])):
                    chars.append(self.character[t[i]])
            texts.append("".join(chars))
            index += length
        return texts


class AttnLabelConverter:
    """[GO] at 0, [s] (EOS) at 1; characters from index 2."""

    def __init__(self, character: str):
        self.character = ["[GO]", "[s]"] + list(character)
        self.dict = {c: i for i, c in enumerate(self.character)}

    def encode(self, texts, batch_max_length: int = 25):
        out = np.zeros((len(texts), batch_max_length + 2), np.int32)
        lengths = []
        for i, t in enumerate(texts):
            tokens = [self.dict[c] for c in t] + [self.dict["[s]"]]
            lengths.append(len(tokens))
            out[i, 1:1 + len(tokens)] = tokens  # position 0 = [GO]
        return out, np.array(lengths, np.int32)

    def decode(self, indices, lengths):
        return ["".join(self.character[i] for i in row[:length])
                for row, length in zip(np.asarray(indices), lengths)]


def rec_preprocess(img: np.ndarray, img_h: int = 32, img_w: int = 100,
                   pad: bool = False) -> np.ndarray:
    """clova ``dataset.test_preprocess`` equivalent: grayscale, resize to
    (img_h, img_w) (aspect-preserving right-pad when ``pad``), normalize to
    [-1, 1], NHWC (1, H, W, 1) float32."""
    import cv2

    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    if pad:
        h, w = img.shape
        ratio = w / float(h)
        resized_w = min(img_w, max(1, int(np.ceil(img_h * ratio))))
        resized = cv2.resize(img, (resized_w, img_h))
        canvas = np.zeros((img_h, img_w), resized.dtype)
        canvas[:, :resized_w] = resized
        if resized_w < img_w:  # replicate right edge (clova NormalizePAD)
            canvas[:, resized_w:] = resized[:, -1:]
        img = canvas
    else:
        img = cv2.resize(img, (img_w, img_h))
    img = img.astype(np.float32) / 127.5 - 1.0
    return img[None, :, :, None]


def predict_batch(image_tensors: np.ndarray, converter,
                  model: RecognitionModel, prediction: str = "Attn",
                  batch_max_length: int = 25) -> list:
    """Greedy decode and cumprod confidence of N crops (a float32 NHWC
    batch) in one forward of ``model``, in eval mode on its device: the
    logits come to the host once, and the softmax maximum, argmax, ``[s]``
    cut and confidence are numpy float64, as in JAX. Returns
    ``[{"pred": str, "score": float}, ...]`` aligned with the batch."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        logits = model(torch.from_numpy(np.ascontiguousarray(
            image_tensors, np.float32)).to(device)).float().cpu().numpy()
    batch_size = logits.shape[0]
    shifted = logits - logits.max(axis=2, keepdims=True)
    exp = np.exp(shifted, dtype=np.float64)
    max_probs = exp.max(axis=2) / exp.sum(axis=2)
    indices = logits.argmax(axis=2)

    if "CTC" in prediction:
        lengths = [logits.shape[1]] * batch_size
        preds_str = converter.decode(indices.reshape(-1), lengths)
    else:
        lengths = [batch_max_length + 1] * batch_size
        preds_str = converter.decode(indices, lengths)

    results = []
    for b in range(batch_size):
        pred = preds_str[b]
        pred_max_prob = max_probs[b]
        if "Attn" in prediction:
            eos = pred.find("[s]")
            if eos >= 0:
                pred = pred[:eos]
                pred_max_prob = pred_max_prob[:eos]
        confidence = float(np.cumprod(pred_max_prob)[-1]) if len(
            pred_max_prob) else 0.0
        results.append({"pred": pred, "score": confidence})
    return results


def predict(image_tensors: np.ndarray, converter, model: RecognitionModel,
            prediction: str = "Attn", batch_max_length: int = 25) -> dict:
    """``predict_batch`` of a batch of one: its first result."""
    return predict_batch(image_tensors, converter, model,
                         prediction=prediction,
                         batch_max_length=batch_max_length)[0]
