"""Training CLI: train the detector from a configuration.

Port of ``db_text_minimal_tpu/cli/train.py``: loads ``config.yaml`` (or
``--config``), builds the train and test datasets (``data.build_dataset``),
their loaders and a TensorBoard writer under ``<root_dir>/<log_dir>/<unix
time>`` (None when ``torch.utils.tensorboard`` does not import, as in JAX),
and runs ``Trainer.fit``, the epoch loop with its per-epoch eval and three
checkpoints. ``--resume`` restores a checkpoint's whole training state;
``--profile_dir`` records the first epoch with ``torch.profiler``
(``utils/profiling.trace``) before ``fit`` runs its epochs, as in JAX. The
model runs on ``--device``, CUDA by default; the CPU must be asked for by
name.

Distributed (``parallel``): with ``--coordinator_address HOST:PORT
--num_processes N --process_id I`` each process joins the group (NCCL on
CUDA, gloo on the CPU), loads its shard of every epoch at
``hps.batch_size / N`` (the configured batch is the global one) and trains
the model in ``DistributedDataParallel``; process 0 alone writes the
TensorBoard log and the checkpoints. The group is left when ``main``
returns. A pruned checkpoint's
``.widths.json`` goes into the configuration (``model.widths``), from
which the ``Trainer`` builds the narrow model and its checkpoints keep
the sidecar.

Usage::

    python -m db_text_minimal_tpu_torch.cli.train [--config config.yaml]
        [--epochs N] [--dataset totaltext] [--resume CKPT] [--device cpu]
        [--profile_dir DIR] [--coordinator_address 127.0.0.1:29500
        --num_processes 2 --process_id 0]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from .. import parallel
from ..config import load_config
from ..data import DataLoader, build_dataset
from ..models.prune import load_widths
from ..train.trainer import Trainer
from ..utils import resolve_device
from ..utils.profiling import trace


def load_args(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint to resume the whole training "
                             "state from")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="record a torch.profiler trace of the first "
                             "epoch into this directory")
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def tensorboard_writer(log_dir: str):
    """A ``SummaryWriter`` on ``log_dir``, or None when TensorBoard's
    writer does not import or does not open, whatever it raises (JAX
    ``cli/train.py:70-75``): training goes on without it."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir)
    except Exception:
        return None


def main(args=None):
    args = args or load_args()
    resolve_device(args.device)   # refuse a missing GPU before any work
    parallel.initialize_distributed(args.coordinator_address,
                                    args.num_processes, args.process_id,
                                    args.device)
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

    os.makedirs(root, exist_ok=True)   # the Trainer's log file goes there
    tb_writer = None
    if parallel.rank() == 0:
        log_dir = os.path.join(root, cfg.logging.log_dir or "logs",
                               str(int(time.time())))
        os.makedirs(log_dir, exist_ok=True)
        tb_writer = tensorboard_writer(log_dir)

    # hps.batch_size is the global batch: each process loads its share
    train_loader = DataLoader(build_dataset(cfg, is_training=True),
                              parallel.local_batch_slice(
                                  int(cfg.hps.batch_size)),
                              shuffle=True,
                              num_hosts=parallel.world_size(),
                              host_id=parallel.rank())
    test_loader = DataLoader(build_dataset(cfg, is_training=False),
                             int(cfg.hps.test_batch_size))
    trainer = Trainer(cfg, train_loader, test_loader, tb_writer=tb_writer)
    state = trainer.resume_state(args.resume) if args.resume else None
    try:
        if args.profile_dir:
            with trace(args.profile_dir):
                state, _, _, _ = trainer.train_epoch(
                    state if state is not None else trainer.init_state(), 0)
        return trainer.fit(state=state)
    finally:
        if tb_writer is not None:
            tb_writer.close()
        if args.coordinator_address is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
