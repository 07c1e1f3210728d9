"""Recognizer training: CTC and attention cross-entropy, Adam, one step at
a time or K in one call.

Counterpart of ``db_text_minimal_tpu/train/recognition_trainer.py``. A step
runs the model in train mode (BN on batch statistics, its running
statistics moved as flax moves them), takes the loss's gradient and applies
Adam with betas (0.9, 0.999) and eps 1e-8 added outside the square root
(optax ``scale_by_adam``) at the learning rate given to that step, with no
clipping and no weight decay: ``torch.optim.Adam`` computes that update.

``ctc_loss`` is ``F.ctc_loss`` per sequence on float32 log-probabilities,
then the mean over the batch (optax's ``ctc_loss`` and JAX's mean; torch's
``reduction="mean"`` would divide each loss by its label length first). A
label that cannot be aligned in T frames (more labels, with repeats, than
frames) gets loss 0 and no gradient (``zero_infinity``): optax gives it a
loss of about 1e5 from its log-epsilon floor, and a bounded gradient
towards its nearest alignment. ROADMAP queue 3 records the gap.
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


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor) -> torch.Tensor:
    """Mean CTC loss of (N, T, C) logits; blank index 0 (as
    ``CTCLabelConverter``); an unalignable label counts 0."""
    n, t, _ = logits.shape
    logp = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    per_seq = F.ctc_loss(logp, labels.long(),
                         torch.full((n,), t, dtype=torch.long),
                         label_lengths.long(), blank=0, reduction="none",
                         zero_infinity=True)
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
