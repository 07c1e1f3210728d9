"""Structured channel pruning CLI: a checkpoint in, a narrower dense
checkpoint out (``models/prune``).

Port of ``db_text_minimal_tpu/cli/prune.py``::

    python -m db_text_minimal_tpu_torch.cli.prune \
        --checkpoint tmp/hb/scratch10.ckpt --out tmp/hb/p50.ckpt \
        --backbone_keep 0.5 --fpn_inner_keep 0.75 --fpn_out_keep 0.5

The pruned checkpoint is written as a ``.pth`` state_dict when ``--out``
ends in ``.pth``, else as a checkpoint of the weights alone, with a
``.widths.json`` sidecar that every loader applies (``cli.common``,
``quality_bench --checkpoint``, ``cli.train``, the handler) and the source's
``.train_config.json`` copied beside it. Evaluate it with ``quality_bench
--eval_only --checkpoint <out>``; fine-tune it with ``quality_bench
--checkpoint <out>`` (the trainer builds the narrow model from the
sidecar). The pruned weights are loaded into the narrow model on
``--device`` (CUDA by default) before anything is written, as a check that
they fit their widths.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import torch

from ..models import DBTextModel
from ..models.prune import (load_widths, prune_dbnet_variables, save_widths,
                            widths_to_model_kwargs)
from ..train.checkpoints import load_params_any, save_checkpoint
from ..utils import resolve_device

_STATS = ("running_mean", "running_var", "num_batches_tracked")


def conv_weight_macs(state_dict: dict) -> float:
    """Sum of per-pixel conv MACs (kh*kw*cin*cout over every conv and
    deconv kernel). Not weighted by feature-map size: use the before/after
    ratio, not the absolute number."""
    total = 0.0
    for key, value in state_dict.items():
        if key.endswith(".weight") and value.dim() == 4:
            total += float(value.numel())
    return total


def _n_params(state_dict: dict) -> int:
    """The parameter count (the JAX ``params`` tree's: BN statistics
    excluded)."""
    return sum(v.numel() for k, v in state_dict.items()
               if not k.endswith(_STATS))


def _keep_arg(s: str):
    """Keep spec: values in (0, 1] are kept fractions, values > 1 absolute
    channel counts (as int). '1' parses as the fraction 1.0 (no pruning);
    a count of exactly one channel is only reachable from the Python API."""
    v = float(s)
    if v > 1:
        return int(round(v))
    return v


def load_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--backbone_keep", type=_keep_arg, default=1.0,
                   help="kept fraction (<=1) or absolute channel count (>1) "
                        "of each BasicBlock's internal conv1 channels "
                        "(1.0 = no pruning; a count of exactly 1 is not "
                        "expressible: '1' means fraction 1.0)")
    p.add_argument("--fpn_inner_keep", type=_keep_arg, default=1.0,
                   help="kept fraction (<=1) or count (>1) of the tied FPN "
                        "reduce/smooth width")
    p.add_argument("--fpn_out_keep", type=_keep_arg, default=1.0,
                   help="kept fraction (<=1) or count (>1) of the FPN "
                        "output (= head input)")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the pruned weights are loaded into the "
                        "narrow model as a check")
    return p.parse_args(argv)


def main(args=None):
    args = args or load_args()
    device = resolve_device(args.device)
    state_dict = load_params_any(args.checkpoint)
    pruned, widths = prune_dbnet_variables(
        state_dict, backbone_keep=args.backbone_keep,
        fpn_inner_keep=args.fpn_inner_keep, fpn_out_keep=args.fpn_out_keep)
    # re-pruning a pruned checkpoint: the source sidecar's widths stand for
    # every group this pass left alone (per block for the backbone, where 0
    # is the default width)
    old = load_widths(args.checkpoint) or {}
    if old:
        merged = {**old, **widths}
        if old.get("backbone_hidden") and widths.get("backbone_hidden"):
            merged["backbone_hidden"] = [
                n or o for n, o in zip(widths["backbone_hidden"],
                                       old["backbone_hidden"])]
        widths = merged
    DBTextModel(**widths_to_model_kwargs(widths)).to(device).load_state_dict(
        pruned, strict=True)

    n_full, n_pruned = _n_params(state_dict), _n_params(pruned)
    f_full, f_pruned = conv_weight_macs(state_dict), conv_weight_macs(pruned)
    if args.out.endswith(".pth"):
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        torch.save(pruned, args.out)
    else:
        save_checkpoint(args.out, {"model": pruned})
    save_widths(args.out, widths)
    # the training provenance goes along (quality_bench's sidecar)
    src_cfg = args.checkpoint + ".train_config.json"
    if os.path.exists(src_cfg):
        shutil.copy(src_cfg, args.out + ".train_config.json")

    report = {
        "widths": widths,
        "params": {"full": int(n_full), "pruned": int(n_pruned),
                   "ratio": round(n_pruned / n_full, 4)},
        "conv_weight_macs": {"full": float(f_full), "pruned": float(f_pruned),
                             "ratio": round(f_pruned / f_full, 4)},
        "out": args.out,
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
