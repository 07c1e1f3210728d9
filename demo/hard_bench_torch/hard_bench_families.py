"""The port's hard-bench rows of the other detector families on one GPU,
made as the JAX package's ``demo/hard_bench/metrics_dcn.json`` (DetEval F
.6537) and ``metrics_fpem.json`` (.7687) were: the committed hard bench
(``make_synthetic --hard``, seed 7, 1600 train and 400 test images,
replayed from the committed text-engine trace), then ``quality_bench`` for
10 epochs at batch 16, lr .005, ``--reduction none``, bf16, of the rows
named by ``--rows`` (the first two by default):

- ``metrics_dcn_bf16``: deformable_resnet18 + FPN,
  ``--dcn_offset_lr_mult 1.0`` (as the JAX row);
- ``metrics_fpem_bf16``: resnet18 + FPEM_FFM;
- ``metrics_dcn_lrmult0.1_bf16``: deformable_resnet18 + FPN at
  ``--dcn_offset_lr_mult 0.1``.

Each step runs as its own process; the reports (``<row><tag>.json``), the
card's name and power limit, the versions and each step's wall seconds go
to ``--out``; data goes to ``--work`` (``tmp/`` by default, which git
ignores)::

    python demo/hard_bench_torch/hard_bench_families.py --out tmp/families
    python demo/hard_bench_torch/hard_bench_families.py --out tmp/d1 \
        --rows metrics_dcn_bf16,metrics_dcn_lrmult0.1_bf16 --tag _d1
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

TRACE = "demo/hard_bench_torch/text_engine_hard_seed7.npz"
PKG = "db_text_minimal_tpu_torch"
ROWS = {"metrics_dcn_bf16": ["--backbone", "deformable_resnet18",
                             "--dcn_offset_lr_mult", "1.0"],
        "metrics_fpem_bf16": ["--neck", "FPEM_FFM"],
        "metrics_dcn_lrmult0.1_bf16": ["--backbone", "deformable_resnet18",
                                       "--dcn_offset_lr_mult", "0.1"]}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    parser.add_argument("--work", default="tmp/families_hard")
    parser.add_argument("--rows", default="metrics_dcn_bf16,"
                                          "metrics_fpem_bf16")
    parser.add_argument("--tag", default="",
                        help="appended to each report's name")
    args = parser.parse_args()
    rows = args.rows.split(",")
    unknown = [r for r in rows if r not in ROWS]
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; known: {list(ROWS)}")
    os.makedirs(args.out, exist_ok=True)
    hb = os.path.join(args.work, "hb")
    walls = {}

    def run(name: str, cmd: list[str]) -> None:
        t0 = time.perf_counter()
        with open(os.path.join(args.out, f"{name}.log"), "w") as log:
            proc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT)
        walls[name] = round(time.perf_counter() - t0, 2)
        print(f"{name}: rc {proc.returncode}, {walls[name]} s", flush=True)
        with open(os.path.join(args.out, "walls.json"), "w") as f:
            json.dump(walls, f, indent=1)
        if proc.returncode:
            raise SystemExit(f"{name} failed: {' '.join(cmd)}")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    versions = subprocess.run(
        [sys.executable, "-c", "import sys, torch, cv2; print(sys.version."
         "split()[0], torch.__version__, torch.version.cuda, "
         "cv2.__version__)"], capture_output=True, text=True).stdout.strip()
    with open(os.path.join(args.out, "card.txt"), "w") as f:
        f.write(f"{card}\n{versions}\n")
    print(card, versions, flush=True)

    py = [sys.executable, "-m"]
    run("make_synthetic", py + [f"{PKG}.cli.make_synthetic", hb, "--hard",
                                "--text_trace", TRACE])
    for row in rows:
        name = row + args.tag
        run(name, py + [
            f"{PKG}.cli.quality_bench", "--data_dir", hb, "--out",
            os.path.join(args.out, f"{name}.json"), "--epochs", "10",
            "--batch_size", "16", "--lr", "0.005", "--reduction", "none"]
            + ROWS[row])
    return 0


if __name__ == "__main__":
    sys.exit(main())
