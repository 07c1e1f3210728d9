#!/usr/bin/env python3
"""Time the bf16 training step of two checkouts in turns on one NVIDIA GPU.

Run from the repository root, with another checkout of the repository (for
example the parent commit, unpacked by ``git archive``)::

    python3 compare_train.py OTHER_CHECKOUT [--turns 2]

The runs alternate, the other checkout first: other, this, this, other,
... Each run is a process of its own, started in the root of its checkout,
so that it imports that checkout's package and ``chip_smoke.py`` and builds
that checkout's kernels. A run trains resnet18 + FPN + DBHead at 640x640 in
bf16 with the default configuration (true per-pixel OHEM, Adam), from
``chip_smoke.SEED``, on one synthetic batch (``chip_smoke.text_batch``) at
batch 16 and at batch 4: ``chip_smoke.TRAIN_STEPS`` steps of
``Trainer.train_epoch``, an event before each step, the median ms of the
steps after the first two, the total losses and a SHA-256 of the
parameters and statistics after them (equal digests: the two trees train
bit for bit alike); then three steps under the profiler: the card's busy
ms a step, its device operations a step and its top kernels by device ms.
It prints one line ``TRAINTIME {json}`` a run, after the card's name and
power limit. Exits non-zero when no GPU is available or a run fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

BATCHES = (16, 4)


def measure(label: str) -> dict:
    """The bf16 training step of the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as S

    out = {"label": label, "root": os.getcwd()}
    with tempfile.TemporaryDirectory() as workdir:
        for batch_size in BATCHES:
            cfg = S.train_config(workdir, S.SIZE, batch_size, "cuda")
            batch = S.text_batch(S.SEED, batch_size, S.SIZE)
            events = []

            def loader():
                for _ in range(S.TRAIN_STEPS):
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                    yield batch

            trainer = S.T.Trainer(cfg, loader(), None)
            state = trainer.init_state()
            state, _, _, _ = trainer.train_epoch(state, 0)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            torch.cuda.synchronize()
            step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            digest = hashlib.sha256()
            for tensor in state.model.state_dict().values():
                digest.update(tensor.detach().cpu().numpy().tobytes())
            losses = [row["total_loss"] for row in trainer.loss_log]
            step = S.T.build_train_step(cfg)
            device_batch = S.T.to_device(batch, torch.device("cuda"))
            busy, by_name, ops = S.device_kernels(
                lambda: step(state, device_batch, S.LR), 3)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            out[f"batch_{batch_size}"] = {
                "step_ms": float(np.median(step_ms[2:])),
                "steps_ms": step_ms, "total_losses": losses,
                "state_sha256": digest.hexdigest(),
                "busy_ms": busy, "device_ops": ops,
                "top_kernels_ms": {S.short_name(k)[:60]: v for k, v in top}}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", nargs="?",
                        help="root of the checkout to compare with")
    parser.add_argument("--turns", type=int, default=2,
                        help="pairs of runs (default 2)")
    parser.add_argument("--one", metavar="LABEL",
                        help="measure the checkout in the working directory")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_train: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print("TRAINTIME " + json.dumps(measure(args.one)), flush=True)
        return 0
    if not args.other:
        parser.error("give the root of the other checkout")
    this = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    order = []
    for turn in range(args.turns):
        pair = [("other", other), ("this", this)]
        order += pair if turn % 2 == 0 else pair[::-1]
    for label, root in order:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", label], cwd=root)
        if run.returncode != 0:
            print(f"compare_train: the run of {root} failed",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
