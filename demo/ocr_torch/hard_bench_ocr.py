"""The port's hard-bench OCR rows on one GPU, the JAX package's
``demo/ocr/`` rows made the same way (``benchmarks/chains/chain50.sh``
steps 9 and 10):

1. the committed hard bench (``make_synthetic --hard``, seed 7, 1600 train
   and 400 test images), replayed from the committed text-engine trace;
2. the detector: ``quality_bench`` for 10 epochs at batch 16, lr .005,
   ``--reduction none --polygon``, bf16 (the settings of
   ``demo/hard_bench_torch/metrics_scratch10_bf16.json``), saved;
3. ``export_word_crops`` of the train split with its defaults (4 jittered
   copies of each GT word, seed 0);
4. ``train_rec`` of the base recognizer (None/VGG/BiLSTM/CTC, 512/256) for
   12 epochs at batch 32, lr 1e-3, then ``rec_bench --mode rec``;
5. ``rec_bench --mode e2e`` of that recognizer behind the step-2 detector;
6. the same training and ``--mode rec`` for None/ResNet/BiLSTM/Attn, the
   configuration ``cli/ocr`` serves by default.

Each step runs as its own process; the reports, the card's name and power
limit, the versions and each step's wall seconds go to ``--out``. Data,
crops and checkpoints go to ``--work`` (``tmp/`` by default, which git
ignores)::

    python demo/ocr_torch/hard_bench_ocr.py --out tmp/ocr_reports
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


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    parser.add_argument("--work", default="tmp/ocr_hard")
    args = parser.parse_args()
    os.makedirs(args.out, exist_ok=True)
    hb, models = (os.path.join(args.work, d) for d in ("hb", "models"))
    crops = os.path.join(args.work, "crops")
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
    det = os.path.join(models, "scratch10.ckpt")
    run("detector", py + [
        f"{PKG}.cli.quality_bench", "--data_dir", hb, "--out",
        os.path.join(args.out, "metrics_scratch10_bf16.json"), "--epochs",
        "10", "--batch_size", "16", "--lr", "0.005", "--reduction", "none",
        "--polygon", "--save_checkpoint", det])
    run("export_word_crops", [sys.executable, "-c", (
        "import os, sys\n"
        f"from {PKG}.data.synthetic import export_word_crops\n"
        "hb, out = sys.argv[1:3]\n"
        "export_word_crops({'train_dir': os.path.join(hb, 'train_images'),"
        " 'train_gt_dir': os.path.join(hb, 'train_gts')}, out)\n"
        "n = sum(1 for _ in open(os.path.join(out, 'labels.txt')))\n"
        "print(f'{n} crops (the JAX chain: 22.8k)')\n"), hb, crops])
    for name, stages in (("base", []),
                         ("attn", ["--FeatureExtraction", "ResNet",
                                   "--Prediction", "Attn"])):
        rec = os.path.join(models, f"rec_hard_{name}.ckpt")
        run(f"train_rec_{name}", py + [
            f"{PKG}.cli.train_rec", "--crop_dir", crops, "--epochs", "12",
            "--batch_size", "32", "--lr", "1e-3", "--out", rec] + stages)
        run(f"rec_bench_{name}", py + [
            f"{PKG}.cli.rec_bench", "--mode", "rec", "--data_dir", hb,
            "--saved_model", rec, "--out",
            os.path.join(args.out, f"rec_accuracy_hard_{name}.json")]
            + stages)
        if name == "base":
            run("e2e", py + [
                f"{PKG}.cli.rec_bench", "--mode", "e2e", "--data_dir", hb,
                "--det_model_path", det, "--saved_model", rec, "--out",
                os.path.join(args.out, "ocr_e2e_hard.json")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
