"""Training CLI: train the detector from a configuration.

Port of ``db_text_minimal_tpu/cli/train.py`` for one card: loads
``config.yaml`` (or ``--config``), builds the train and test datasets
(``data.build_dataset``) and their loaders, and runs ``Trainer.fit``, the
epoch loop with its per-epoch eval and three checkpoints. ``--resume``
restores a checkpoint's whole training state. The model runs on
``--device``, CUDA by default; the CPU must be asked for by name.

Not ported here: the multi-host flags (ROADMAP queue 1 item 10),
``--profile_dir`` and the TensorBoard writer (item 9). A pruned checkpoint's
``.widths.json`` goes into the configuration (``model.widths``), from
which the ``Trainer`` builds the narrow model and its checkpoints keep
the sidecar.

Usage::

    python -m db_text_minimal_tpu_torch.cli.train [--config config.yaml]
        [--epochs N] [--dataset totaltext] [--resume CKPT] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from ..config import load_config
from ..data import DataLoader, build_dataset
from ..models.prune import load_widths
from ..train.trainer import Trainer
from ..utils import resolve_device


def load_args(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint to resume the whole training "
                             "state from")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def main(args=None):
    args = args or load_args()
    resolve_device(args.device)   # refuse a missing GPU before any work
    overrides = {"meta": {"device": args.device}}
    if args.dataset:
        overrides["dataset"] = {"name": args.dataset}
    if args.epochs is not None:
        overrides["hps"] = {"no_epochs": args.epochs}
    cfg = load_config(args.config, overrides)
    root = cfg.meta.root_dir or "."
    # a pruned checkpoint's widths go into the configuration (the finetune
    # path is relative to root_dir, as in Trainer.init_state)
    ft = cfg.model.finetune_cp_path
    for ckpt in (args.resume, os.path.join(root, str(ft)) if ft else None):
        if ckpt:
            widths = load_widths(ckpt)
            if widths:
                cfg["model"]["widths"] = widths
                break

    train_loader = DataLoader(build_dataset(cfg, is_training=True),
                              int(cfg.hps.batch_size), shuffle=True)
    test_loader = DataLoader(build_dataset(cfg, is_training=False),
                             int(cfg.hps.test_batch_size))
    trainer = Trainer(cfg, train_loader, test_loader)
    state = trainer.resume_state(args.resume) if args.resume else None
    return trainer.fit(state=state)


if __name__ == "__main__":
    main()
