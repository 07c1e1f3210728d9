"""Checkpoint loading: reference-format ``.pth`` state_dicts.

Counterpart of ``db_text_minimal_tpu/train/checkpoints.py::load_params_any``
for ``.pth`` files only. A ``.pth`` written from ``weights.state_dict_from_jax``
or by the reference loads into both packages. The JAX package's own Flax
msgpack / orbax ``.ckpt`` files are not read yet.
"""

from __future__ import annotations

import torch

# the reference's backbone modules that its forward pass never calls
_UNUSED_PREFIXES = ("backbone.fc.", "backbone.avgpool.", "backbone.smooth.")


def load_params_any(path: str) -> dict:
    """State_dict from a ``.pth`` file, with the ``module.`` prefix of a
    DataParallel save and the reference's unused modules removed."""
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: only .pth state_dicts load in the PyTorch port; Flax "
            f"msgpack/orbax .ckpt loading is a ROADMAP item")
    sd = torch.load(path, map_location="cpu", weights_only=True)
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
