"""Checkpoints: the full training state, the three-checkpoint policy, and
weight loading.

Counterpart of ``db_text_minimal_tpu/train/checkpoints.py``. A checkpoint is
one ``torch.save`` file of ``{"model": state_dict, "optimizer": Adam
state_dict, "step": int}``, with the reference's key names in the model's
state_dict, and a ``<path>.json`` of metadata beside it. ``load_params_any``
reads the model weights of such a file or of a reference-format ``.pth``
state_dict, or of a JAX package Flax msgpack ``.ckpt`` (``flax_msgpack``:
its ``params`` and ``batch_stats`` through ``weights.state_dict_from_jax``,
or ``rec_state_dict_from_jax`` for a recognizer's; its ``opt_state`` and
``step`` are read and left). An orbax checkpoint directory is not read. A
pruned checkpoint carries its channel widths in a
``<path>.widths.json`` sidecar (``models/prune``): a ``CheckpointPolicy``
given ``widths`` writes it beside every checkpoint it saves. A recognizer
checkpoint (``cli/train_rec``) has the same three entries, its model keys
under ``transformation``, ``feature_extraction``, ``seq1``, ``seq2`` and
``prediction``, which the unused-module filter leaves alone.
"""

from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch

from ..models.prune import save_widths
from .flax_msgpack import is_flax_msgpack, msgpack_restore

# the reference's backbone modules that its forward pass never calls
_UNUSED_PREFIXES = ("backbone.fc.", "backbone.avgpool.", "backbone.smooth.")


def save_checkpoint(path: str, state: dict, metadata: dict | None = None
                    ) -> None:
    """Write ``state`` to ``path`` through a temporary file, so a reader
    never sees half of it, and ``metadata`` to ``<path>.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def restore_checkpoint(path: str) -> dict:
    """The state dict that ``save_checkpoint`` wrote, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def flax_state_dict(path: str) -> dict:
    """The model state_dict of a JAX package Flax msgpack checkpoint: a
    detector's (its params hold ``backbone``) or a recognizer's."""
    from ..weights import rec_state_dict_from_jax, state_dict_from_jax

    with open(path, "rb") as f:
        state = msgpack_restore(f.read())
    params, stats = state["params"], state.get("batch_stats", {})
    if "backbone" in params:
        return state_dict_from_jax(params, stats)
    return rec_state_dict_from_jax(params, stats)


def load_params_any(path: str) -> dict:
    """Model state_dict from a ``.pth`` file (with the ``module.`` prefix of
    a DataParallel save and the reference's unused modules removed), from
    a checkpoint of ``save_checkpoint`` or from a JAX package Flax
    checkpoint (``flax_state_dict``)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory, an orbax checkpoint: only Flax msgpack "
            f"checkpoints of the JAX package load (ROADMAP queue 1, orbax)")
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    elif zipfile.is_zipfile(path):
        sd = restore_checkpoint(path).get("model")
    elif is_flax_msgpack(path):
        sd = flax_state_dict(path)
    else:
        raise ValueError(f"{path} is neither a torch file nor a Flax "
                         f"msgpack checkpoint")
    if not isinstance(sd, dict):
        raise TypeError(f"{path} holds a {type(sd).__name__}, not a "
                        f"state_dict")
    out = {}
    for key, value in sd.items():
        if key.startswith("module."):
            key = key[len("module."):]
        if not key.startswith(_UNUSED_PREFIXES):
            out[key] = value
    return out


class CheckpointPolicy:
    """The reference's three checkpoints: best hmean, best train and test
    loss together, and last. With a pruned model's ``widths``, each
    checkpoint gets the ``.widths.json`` sidecar, without which a loader
    would build the default widths against narrow weights (JAX
    checkpoints.py:103-113)."""

    def __init__(self, root_dir: str, best_cp_path: str, last_cp_path: str,
                 best_hmean_cp_path: str, widths: dict | None = None):
        self.widths = dict(widths) if widths else None
        self.best_cp_path = os.path.join(root_dir, best_cp_path)
        self.last_cp_path = os.path.join(root_dir, last_cp_path)
        self.best_hmean_cp_path = os.path.join(root_dir, best_hmean_cp_path)
        self.best_test_loss = np.inf
        self.best_train_loss = np.inf
        self.best_hmean = 0.0

    def _save(self, path: str, state, meta) -> None:
        save_checkpoint(path, state, meta)
        if self.widths:
            save_widths(path, self.widths)

    def on_epoch_end(self, state, *, train_loss: float, test_loss: float,
                     hmean: float, epoch: int) -> list[str]:
        saved = []
        meta = {"epoch": epoch, "train_loss": train_loss,
                "test_loss": test_loss, "hmean": hmean}
        if hmean >= self.best_hmean:
            self.best_hmean = hmean
            self._save(self.best_hmean_cp_path, state, meta)
            saved.append(self.best_hmean_cp_path)
        if (test_loss <= self.best_test_loss
                and train_loss <= self.best_train_loss):
            self.best_test_loss = test_loss
            self.best_train_loss = train_loss
            self._save(self.best_cp_path, state, meta)
            saved.append(self.best_cp_path)
        return saved

    def on_train_end(self, state, epoch: int) -> str:
        self._save(self.last_cp_path, state, {"epoch": epoch})
        return self.last_cp_path
