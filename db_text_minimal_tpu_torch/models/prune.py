"""Structured (channel) pruning of the detector's state_dict.

Port of ``db_text_minimal_tpu/models/prune.py`` over a torch state_dict with
the reference's key names (OIHW kernels; BN ``weight``, ``bias``,
``running_mean``, ``running_var``). Channels are removed physically and
every consumer is re-sliced, so the result is a smaller dense model. Three
groups can be pruned without touching a residual tie:

1. each BasicBlock's hidden width (conv1 -> bn1 -> relu -> conv2);
2. the FPN's inner add-chain, one keep-set tied across the reduce and
   smooth convs and the four input segments of the output conv;
3. the FPN output, which is the head's input; the head's branch width is
   pinned first, so the head keeps its own width.

A channel's importance is its BN-folded output norm ``||W_c||_2 *
|gamma_c| / sqrt(var_c + eps)``, computed in float64 numpy on the kernel
laid out as the JAX package lays it out (HWIO), so that ties fall as
``np.argsort(scores)[::-1]`` lets them fall there. ``prune_dbnet_variables``
returns the pruned state_dict and a ``widths`` dict of ``DBTextModel``'s
override fields; ``save_widths``/``load_widths`` keep it beside a
checkpoint as ``<checkpoint>.widths.json``, which the loaders, the trainer
and the checkpoint policy apply.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

BN_EPS = 1e-5
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_REDUCES = tuple(f"reduce_conv_c{i}" for i in (2, 3, 4, 5))
_SMOOTHS = tuple(f"smooth_p{i}" for i in (2, 3, 4))
_BLOCK = re.compile(r"^backbone\.layer(\d+)\.(\d+)\.conv1\.weight$")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _folded_out_norms(weight: torch.Tensor, sd: dict, bn: str) -> np.ndarray:
    """Per-output-channel contribution of an OIHW conv followed by the BN
    at ``bn``: kernel L2 norm times |gamma| / sqrt(var + eps), in float64
    over the HWIO kernel (the JAX package's layout and summation order)."""
    k = np.ascontiguousarray(np.transpose(_np(weight), (2, 3, 1, 0)))
    k = k.astype(np.float64)
    norms = np.sqrt((k ** 2).sum(axis=tuple(range(k.ndim - 1))))
    gamma = np.abs(_np(sd[f"{bn}.weight"]).astype(np.float64))
    var = _np(sd[f"{bn}.running_var"]).astype(np.float64)
    return norms * gamma / np.sqrt(var + BN_EPS)


def _prunable(keep) -> bool:
    """True when ``keep`` asks for pruning. Floats are kept fractions
    (None or 1.0 leave the group alone); ints are absolute channel counts,
    so the int 1 keeps exactly one channel (``1 == 1.0`` must not swallow
    it); bools are not counts."""
    if keep is None or isinstance(keep, bool):
        return False
    if isinstance(keep, int):
        return True
    return float(keep) != 1.0


def _keep_indices(scores: np.ndarray, keep: float | int) -> np.ndarray:
    """The sorted indices of the ``keep`` highest scores (a fraction of
    them, or a count), ties broken as ``np.argsort(scores)[::-1]``."""
    n = scores.shape[0]
    k = keep if isinstance(keep, int) else max(1, int(round(keep * n)))
    k = min(max(k, 1), n)
    return np.sort(np.argsort(scores)[::-1][:k])


def _take(sd: dict, key: str, idx: np.ndarray, dim: int) -> None:
    sd[key] = sd[key].index_select(dim, torch.as_tensor(idx)).contiguous()


def _slice_out(sd: dict, conv: str, idx) -> None:
    _take(sd, f"{conv}.weight", idx, 0)
    if f"{conv}.bias" in sd:
        _take(sd, f"{conv}.bias", idx, 0)


def _slice_bn(sd: dict, bn: str, idx) -> None:
    for leaf in _BN_LEAVES:
        _take(sd, f"{bn}.{leaf}", idx, 0)


def _blocks(sd: dict) -> list[str]:
    """The backbone blocks' key prefixes in creation order (layer1.0,
    layer1.1, ..., layer4.N)."""
    found = []
    for key in sd:
        m = _BLOCK.match(key)
        if m:
            found.append((int(m.group(1)), int(m.group(2))))
    return [f"backbone.layer{s}.{b}" for s, b in sorted(found)]


def _is_basic_plain(sd: dict, block: str) -> bool:
    """A BasicBlock whose conv2 is a plain conv (no Bottleneck conv3, no
    deformable conv2's offset branch)."""
    if f"{block}.conv3.weight" in sd:
        return False
    return not any(k.startswith(f"{block}.conv2.") and
                   k not in (f"{block}.conv2.weight", f"{block}.conv2.bias")
                   for k in sd)


def prune_dbnet_variables(state_dict: dict, *, backbone_keep=1.0,
                          fpn_inner_keep=None, fpn_out_keep=None):
    """Magnitude-prune a trained ``DBTextModel`` state_dict. Each
    ``*_keep`` is a kept fraction or an absolute channel count; 1.0 or None
    leaves a group alone. Returns ``(pruned_state_dict, widths)``; the
    input is not modified. As in JAX, only plain BasicBlocks prune (a
    Bottleneck or a deformable block is left whole) and only an FPN neck
    (FPEM_FFM is left whole)."""
    sd = dict(state_dict)
    widths: dict[str, Any] = {}

    # group 1: each BasicBlock's hidden channels
    hidden = []
    for block in _blocks(sd):
        if not (_prunable(backbone_keep) and _is_basic_plain(sd, block)):
            hidden.append(0)   # 0 keeps the default width
            continue
        scores = _folded_out_norms(sd[f"{block}.conv1.weight"], sd,
                                   f"{block}.bn1")
        idx = _keep_indices(scores, backbone_keep)
        _slice_out(sd, f"{block}.conv1", idx)
        _slice_bn(sd, f"{block}.bn1", idx)
        _take(sd, f"{block}.conv2.weight", idx, 1)
        hidden.append(int(idx.shape[0]))
    if any(hidden):
        widths["backbone_hidden"] = hidden

    body = "segmentation_body"
    inner = [f"{body}.{m}" for m in _REDUCES + _SMOOTHS]

    # group 2: the FPN inner add-chain, one tied keep-set
    if _prunable(fpn_inner_keep) and all(f"{m}.conv.weight" in sd
                                         for m in inner):
        q = sd[f"{inner[0]}.conv.weight"].shape[0]
        scores = np.zeros(q, np.float64)
        for m in inner:
            scores += _folded_out_norms(sd[f"{m}.conv.weight"], sd,
                                        f"{m}.bn")
        idx = _keep_indices(scores, fpn_inner_keep)
        for m in inner:
            _slice_out(sd, f"{m}.conv", idx)
            _slice_bn(sd, f"{m}.bn", idx)
        for m in _SMOOTHS:
            _take(sd, f"{body}.{m}.conv.weight", idx, 1)
        # the output conv's input is concat[p2, p3, p4, p5], q wide each
        cat_idx = np.concatenate([idx + s * q for s in range(4)])
        _take(sd, f"{body}.conv.0.weight", cat_idx, 1)
        widths["fpn_inner_quarter"] = int(idx.shape[0])

    # group 3: the FPN output (the head's input)
    if _prunable(fpn_out_keep) and f"{body}.conv.0.weight" in sd:
        scores = _folded_out_norms(sd[f"{body}.conv.0.weight"], sd,
                                   f"{body}.conv.1")
        idx = _keep_indices(scores, fpn_out_keep)
        _slice_out(sd, f"{body}.conv.0", idx)
        _slice_bn(sd, f"{body}.conv.1", idx)
        # pin the head's width before its input shrinks (it defaults to a
        # quarter of its input), then re-slice both branches' first convs
        widths["head_width"] = int(
            sd["segmentation_head.binarize.0.weight"].shape[0])
        for branch in ("binarize", "thresh"):
            _take(sd, f"segmentation_head.{branch}.0.weight", idx, 1)
        widths["fpn_out"] = int(idx.shape[0])
    return sd, widths


def widths_to_model_kwargs(widths: dict | None) -> dict:
    """A widths sidecar as ``DBTextModel`` constructor kwargs."""
    if not widths:
        return {}
    kw = {}
    if widths.get("backbone_hidden"):
        kw["backbone_hidden"] = tuple(widths["backbone_hidden"])
    for key in ("fpn_inner_quarter", "fpn_out", "head_width"):
        if widths.get(key):
            kw[key] = int(widths[key])
    return kw


def save_widths(ckpt_path: str, widths: dict) -> str:
    sidecar = ckpt_path + ".widths.json"
    with open(sidecar, "w") as f:
        json.dump(widths, f)
    return sidecar


def load_widths(ckpt_path: str) -> dict | None:
    """The ``<checkpoint>.widths.json`` sidecar of a pruned checkpoint, or
    None when there is none."""
    sidecar = ckpt_path + ".widths.json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return None
