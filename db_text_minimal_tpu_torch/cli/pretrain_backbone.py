"""Pretrain a ResNet backbone on a pretext task and write torchvision-key
``.pth`` weights for ``model.pretrained_backbone_path``.

Port of ``db_text_minimal_tpu/cli/pretrain_backbone.py``, with the same
flags and defaults (``train/backbone_pretrain``) and ``--device``, CUDA by
default.

Usage::

    python -m db_text_minimal_tpu_torch.cli.pretrain_backbone \\
        --train_dir data/train_images --gt_dir data/train_gts \\
        --out models/backbone_pretext.pth [--pretext dense|classify]
        [--steps N] [--backbone resnet18] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

from ..train.backbone_pretrain import (pretrain_backbone,
                                       pretrain_backbone_dense)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--train_dir", type=str, required=True)
    parser.add_argument("--gt_dir", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--pretext", type=str, default="dense",
                        choices=("dense", "classify"),
                        help="dense = per-cell text layout at stride 8 "
                             "(the warm start that transfers); classify = "
                             "text/no-text crops")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--limit_images", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    common = {"backbone": args.backbone, "batch_size": args.batch_size,
              "seed": args.seed, "device": args.device}
    if args.pretext == "dense":
        result = pretrain_backbone_dense(
            args.train_dir, args.gt_dir, args.out,
            steps=1000 if args.steps is None else args.steps,
            lr=2e-3 if args.lr is None else args.lr,
            limit_images=(512 if args.limit_images is None
                          else args.limit_images), **common)
    else:
        result = pretrain_backbone(
            args.train_dir, args.gt_dir, args.out,
            steps=300 if args.steps is None else args.steps,
            lr=1e-3 if args.lr is None else args.lr,
            limit_images=(256 if args.limit_images is None
                          else args.limit_images), **common)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
