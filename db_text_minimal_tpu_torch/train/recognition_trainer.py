"""Recognizer training: CTC and attention cross-entropy, Adam, one step at
a time or K in one call.

Counterpart of ``db_text_minimal_tpu/train/recognition_trainer.py``. A step
runs the model in train mode (BN on batch statistics, its running
statistics moved as flax moves them), takes the loss's gradient and applies
Adam with betas (0.9, 0.999) and eps 1e-8 added outside the square root
(optax ``scale_by_adam``) at the learning rate given to that step, with no
clipping and no weight decay: ``torch.optim.Adam`` computes that update.

``ctc_loss`` is ``optax.ctc_loss(...).mean()``, the JAX loss, in value and
gradient: ``F.ctc_loss`` per sequence on float32 log-probabilities (torch's
``reduction="mean"`` would divide each loss by its label length first),
then the mean over the batch. A label that cannot be aligned in T frames
(more labels, with its repeats, than frames) is infinite for torch; optax
gives it a loss of about 1e5 from its ``log_epsilon`` floor and a bounded
gradient towards its nearest alignment. Such sequences take
``_optax_ctc``, optax's log-space forward recursion
(``losses/_classification.py`` 690-760 of optax 0.2.6) in plain PyTorch,
with the gradient by autograd.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..models.recognition import RecognitionModel


@dataclass
class RecTrainState:
    model: RecognitionModel
    optimizer: torch.optim.Optimizer
    step: int = 0


LOG_EPSILON = -1e5   # optax's ``log_epsilon``, its log(+0)


def _optax_ctc(logp: torch.Tensor, labels: torch.Tensor,
               label_lengths: torch.Tensor) -> torch.Tensor:
    """Per-sequence CTC loss of (B, T, C) log-probabilities as optax's
    ``ctc_loss_with_forward_probs`` computes it with no logit padding:
    states of blank (``phi``, N + 1 of them) and of label (``emit``, N),
    log(0) as ``LOG_EPSILON``, blank index 0. ``labels`` is (B, N),
    right-padded; the padding's values enter through ``repeat`` as in
    optax."""
    b, t, _ = logp.shape
    n = labels.shape[1]
    labels = labels.long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    lp_phi = logp[:, :, :1].transpose(0, 1)                       # T, B, 1
    lp_emit = logp.gather(2, labels[:, None, :].expand(b, t, n)
                          ).transpose(0, 1)                       # T, B, N
    phi = torch.full((b, n + 1), LOG_EPSILON, device=logp.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPSILON, device=logp.device)

    def add_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)],
                         dim=-1)

    for step in range(t):
        prev_phi = add_phi(phi, emit + LOG_EPSILON * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[step],
                                    emit + lp_emit[step])
        next_phi = add_phi(prev_phi + lp_phi[step], emit + lp_phi[step]
                           + LOG_EPSILON * (1.0 - repeat))
        phi, emit = next_phi, next_emit
    last = add_phi(phi, emit)
    return -last.gather(1, label_lengths.long()[:, None])[:, 0]


def _unalignable(labels: torch.Tensor, label_lengths: torch.Tensor,
                 frames: int) -> torch.Tensor:
    """True where a label needs more than ``frames`` frames: one a label,
    and one more between each pair of equal neighbours."""
    lengths = label_lengths.long()
    pairs = torch.arange(labels.shape[1] - 1, device=labels.device)
    repeats = ((labels[:, 1:] == labels[:, :-1])
               & (pairs[None] < lengths[:, None] - 1)).sum(1)
    return lengths + repeats > frames


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor) -> torch.Tensor:
    """Mean CTC loss of (N, T, C) logits; blank index 0 (as
    ``CTCLabelConverter``); ``optax.ctc_loss(...).mean()``, an
    unalignable label included."""
    n, t, _ = logits.shape
    logp = F.log_softmax(logits.float(), dim=-1)
    per_seq = F.ctc_loss(logp.transpose(0, 1), labels.long(),
                         torch.full((n,), t, dtype=torch.long),
                         label_lengths.long(), blank=0, reduction="none",
                         zero_infinity=True)
    bad = _unalignable(labels, label_lengths, t)
    if bad.any():
        idx = bad.nonzero()[:, 0]
        per_seq = per_seq.index_put(
            (idx,), _optax_ctc(logp[idx], labels[idx], label_lengths[idx]))
    return per_seq.mean()


def attn_loss(logits: torch.Tensor, targets: torch.Tensor,
              target_lengths: torch.Tensor) -> torch.Tensor:
    """Cross entropy over decode steps, masked past each sequence's EOS.
    ``targets`` holds [GO] at position 0 (``AttnLabelConverter.encode``);
    the decoder predicts positions 1..T."""
    t = logits.shape[1]
    gold = targets[:, 1:t + 1].long()
    mask = (torch.arange(t, device=logits.device)[None, :]
            < target_lengths[:, None]).float()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, gold[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def init_rec_state(model: RecognitionModel, seed: int = 0,
                   device="cuda") -> RecTrainState:
    """Seeded weights (``reset_parameters`` from a ``torch.Generator`` of
    ``seed``), the model on ``device``, and a fresh Adam."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device).flatten_parameters()
    optimizer = torch.optim.Adam(
        [p for p in model.parameters() if p.requires_grad], lr=0.0,
        betas=(0.9, 0.999), eps=1e-8)
    return RecTrainState(model, optimizer)


def build_rec_train_step(state: RecTrainState):
    """``step(images, targets, lengths, lr) -> loss``: one optimizer step on
    a float NHWC batch on the model's device. The gradients stay in each
    parameter's ``.grad`` until the next step."""
    model, optimizer = state.model, state.optimizer
    is_ctc = model.prediction_name == "CTC"

    def train_step(images, targets, lengths, lr) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=False)
        if is_ctc:
            loss = ctc_loss(model(images), targets, lengths)
        else:
            loss = attn_loss(model(images, text=targets), targets, lengths)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        optimizer.step()
        state.step += 1
        return loss.detach()

    return train_step


def build_rec_chain_step(state: RecTrainState):
    """``chain(images_u8, targets, lengths, lr) -> losses``: K optimizer
    steps over a stacked (K, B, ...) macro-batch, images as uint8
    normalized on the device by ``u8/127.5 - 1`` (bit for bit
    ``rec_preprocess``'s formula). K steps in one call are K calls of the
    single step; the losses stay on the device."""
    step = build_rec_train_step(state)

    def chain(images_u8, targets, lengths, lr) -> torch.Tensor:
        losses = [step(im.float() / 127.5 - 1.0, tg, ln, lr)
                  for im, tg, ln in zip(images_u8, targets, lengths)]
        return torch.stack(losses)

    return chain
