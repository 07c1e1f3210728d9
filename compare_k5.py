#!/usr/bin/env python3
"""Time K5 (the oriented boxes, ``ops/cc.rotated_boxes``) of two checkouts
in turns on one NVIDIA GPU.

Run from the repository root, with another checkout of the repository
(for example the parent commit, unpacked by ``git archive``)::

    python3 compare_k5.py OTHER_CHECKOUT [--turns 2]

The runs alternate, the other checkout first: other, this, this, other,
... Each run is a process of its own, started in the root of its
checkout, so that it imports that checkout's package and ``chip_smoke.py``
and builds that checkout's kernels. A run holds K5 to its plain version
on the 8 kernel scenes of ``chip_smoke.py`` and on the maps of the batch
it serves (its ``phase_serve``, weights from the seed), and prints one
line ``K5TIME {json}``: per input the card's time per call from
torch.profiler, split by launch, and the time per call from CUDA events;
and ``device_boxes``' time on the card for the scenes. Exits non-zero
when no GPU is available or a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def measure(label: str) -> dict:
    """K5 of the checkout in the working directory, on both inputs."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as S
    from db_text_minimal_tpu_torch.ops import cc

    dev = torch.device("cuda")
    cc.load_library()
    scenes = torch.from_numpy(
        np.stack([S.kernel_scene(i) for i in range(S.N)])).to(dev)
    with tempfile.TemporaryDirectory() as workdir:
        _, _, preds, _ = S.phase_serve(workdir)
    out = {"label": label, "root": os.getcwd()}
    for name, prob in (("scenes", scenes), ("served",
                                            preds[..., 0].contiguous())):
        mask = prob > 0.3
        keyed, valid_root = cc.compact_slots(cc.connected_components(mask),
                                             S.K)
        bg_keyed, _ = cc.compact_slots(cc.connected_components(~mask, 4),
                                       S.K)
        hole = cc.hole_stats(mask, keyed, bg_keyed, prob, S.K)
        args = (prob, keyed, valid_root) + hole + (S.K,)
        got, ref = cc.rotated_boxes(*args), cc.rotated_boxes_plain(*args)
        valid = ref[3]
        if not torch.equal(got[3], valid):
            raise AssertionError(f"{label}, {name}: valid slots differ")
        err = max((got[i] - ref[i])[valid].abs().max().item()
                  if valid.any() else 0.0 for i in (0, 1))
        dev_ms, split = S.device_kernels(lambda: cc.rotated_boxes(*args), 50)
        out[name] = {"corner_err": err,
                     "score_err": (got[2] - ref[2]).abs().max().item(),
                     "ms": S.timed(lambda: cc.rotated_boxes(*args), 50),
                     "device_ms": dev_ms,
                     "split": {S.short_name(k): v for k, v in split.items()}}
    out["device_boxes_device_ms"], _ = S.device_kernels(
        lambda: cc.device_boxes(scenes), 20)
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
        print("compare_k5: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print("K5TIME " + json.dumps(measure(args.one)), flush=True)
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
            print(f"compare_k5: the run of {root} failed", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
