"""Recognizer training CLI.

Port of ``db_text_minimal_tpu/cli/train_rec.py``: trains a
``RecognitionModel`` on a directory of word crops with a ``labels.txt``
(``<filename>\\t<text>`` per line, as ``data.synthetic.export_word_crops``
writes it), then saves a checkpoint of ``{"model", "optimizer", "step"}``
with the JAX CLI's metadata sidecar (the whole stage configuration, so
``rec_bench`` and ``ocr`` runs can be checked against it). The batch order
is ``np.random.RandomState(seed).permutation`` per epoch, as in JAX, so both
packages see the same batches; the weights are drawn from a
``torch.Generator`` of the same seed. ``--steps_per_call`` chains that many
steps in one call of the chain step and leaves the result unchanged. The
model runs on ``--device``, CUDA by default, in float32 with TF32 off.

Usage::

    python -m db_text_minimal_tpu_torch.cli.train_rec --crop_dir crops/ \\
        --epochs 10 --out models/rec.ckpt \\
        [--Transformation None --FeatureExtraction VGG
         --SequenceModeling BiLSTM --Prediction CTC] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..models.recognition import (AttnLabelConverter, CTCLabelConverter,
                                  RecognitionModel, rec_preprocess)
from ..train.checkpoints import load_params_any, save_checkpoint
from ..train.recognition_trainer import build_rec_chain_step, init_rec_state
from ..utils import resolve_device, setup_logger
from .common import _fp32_convolutions


def load_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--crop_dir", type=str, required=True,
                        help="directory of word crops + labels.txt")
    parser.add_argument("--out", type=str, default="./models/rec.ckpt")
    parser.add_argument("--init_from", type=str, default=None,
                        help="warm-start the weights and BN statistics from "
                        "an existing recognition checkpoint (fine-tuning); "
                        "the optimizer state starts fresh")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--steps_per_call", type=int, default=16,
                        help="optimizer steps chained in one call; the "
                        "trained result is the same for any value")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--character", type=str,
                        default="0123456789abcdefghijklmnopqrstuvwxyz")
    parser.add_argument("--batch_max_length", type=int, default=25)
    parser.add_argument("--imgH", type=int, default=32)
    parser.add_argument("--imgW", type=int, default=100)
    parser.add_argument("--PAD", action="store_true")
    parser.add_argument("--Transformation", type=str, default="None")
    parser.add_argument("--FeatureExtraction", type=str, default="VGG")
    parser.add_argument("--SequenceModeling", type=str, default="BiLSTM")
    parser.add_argument("--Prediction", type=str, default="CTC")
    parser.add_argument("--hidden_size", type=int, default=256)
    parser.add_argument("--output_channel", type=int, default=512)
    parser.add_argument("--num_fiducial", type=int, default=20)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def load_crop_dataset(opt):
    """(images (N, H, W, 1) float32, texts list) from crop_dir/labels.txt."""
    import cv2

    labels_fp = os.path.join(opt.crop_dir, "labels.txt")
    assert os.path.exists(labels_fp), labels_fp
    images, texts = [], []
    charset = set(opt.character)
    with open(labels_fp) as f:
        for line in f:
            if "\t" not in line:
                continue
            fname, text = line.rstrip("\n").split("\t", 1)
            text = "".join(c for c in text.lower() if c in charset)
            if not text or len(text) > opt.batch_max_length:
                continue
            img = cv2.imread(os.path.join(opt.crop_dir, fname))
            if img is None:
                continue
            images.append(rec_preprocess(img[:, :, ::-1], img_h=opt.imgH,
                                         img_w=opt.imgW, pad=opt.PAD))
            texts.append(text)
    assert images, f"no usable samples in {opt.crop_dir}"
    return np.concatenate(images), texts


def main(opt):
    logger = setup_logger()
    device = resolve_device(opt.device)
    _fp32_convolutions()
    if "CTC" in opt.Prediction:
        converter = CTCLabelConverter(opt.character)
    else:
        converter = AttnLabelConverter(opt.character)
    model = RecognitionModel(
        num_class=len(converter.character),
        transformation=opt.Transformation,
        feature_extraction=opt.FeatureExtraction,
        sequence_modeling=opt.SequenceModeling,
        prediction=opt.Prediction,
        hidden_size=opt.hidden_size,
        output_channel=opt.output_channel,
        num_fiducial=opt.num_fiducial,
        batch_max_length=opt.batch_max_length)
    state = init_rec_state(model, seed=opt.seed, device=device)
    if opt.init_from:
        logger.info("fine-tuning from %s", opt.init_from)
        model.load_state_dict(load_params_any(opt.init_from), strict=True)
        model.flatten_parameters()
    chain = build_rec_chain_step(state)

    images, texts = load_crop_dataset(opt)
    targets, lengths = converter.encode(texts, opt.batch_max_length)
    # uint8 on the way to the device, normalized there by the chain step
    # (a lossless round trip of rec_preprocess's u8/127.5-1)
    images_u8 = np.clip(np.round((images + 1.0) * 127.5), 0,
                        255).astype(np.uint8)
    del images
    logger.info("training on %d crops, %d classes", len(texts),
                len(converter.character))

    rng = np.random.RandomState(opt.seed)
    n = len(texts)
    bs = min(opt.batch_size, n)
    spc = max(1, opt.steps_per_call)
    steps_per_epoch = n // bs
    last_loss = None
    for epoch in range(opt.epochs):
        order = rng.permutation(n)
        done = 0
        while done < steps_per_epoch:
            k = min(spc, steps_per_epoch - done)
            idx = order[done * bs:(done + k) * bs]

            def stacked(a):
                return torch.from_numpy(a[idx].reshape(
                    k, bs, *a.shape[1:])).to(device)

            losses = chain(stacked(images_u8), stacked(targets),
                           stacked(lengths), opt.lr)
            last_loss = float(losses[-1])
            done += k
        logger.info("epoch %d: loss %.4f", epoch, last_loss)

    # the sidecar carries the whole stage configuration, so that later
    # rec_bench and ocr runs can be checked against it
    save_checkpoint(opt.out, {"model": model.state_dict(),
                              "optimizer": state.optimizer.state_dict(),
                              "step": state.step},
                    {"epochs": opt.epochs, "loss": last_loss,
                     "Transformation": opt.Transformation,
                     "FeatureExtraction": opt.FeatureExtraction,
                     "SequenceModeling": opt.SequenceModeling,
                     "Prediction": opt.Prediction,
                     "hidden_size": opt.hidden_size,
                     "output_channel": opt.output_channel,
                     "num_fiducial": opt.num_fiducial,
                     "imgH": opt.imgH, "imgW": opt.imgW,
                     "character": opt.character,
                     "batch_max_length": opt.batch_max_length,
                     "init_from": opt.init_from or None})
    logger.info("saved %s", opt.out)
    return opt.out, last_loss


if __name__ == "__main__":
    main(load_args())
