"""The flagship's hard-bench rows on one GPU, with the folded and int8
forwards plain and with the JAX package's weight-exact rewrites
(``stem_s2d``, ``deconv_d2s``), on one trained checkpoint.

Steps, each its own process (``--step``), all from the repository root:

1. ``make_synthetic --hard`` (seed 7, 1600 train and 400 test images,
   replayed from the committed text-engine trace) into ``--work``;
2. ``quality_bench`` of the flagship (resnet18 + FPN + DBHead) with the
   JAX hard-bench settings (10 epochs, batch 16, lr .005, ``--reduction
   none``, bf16 on CUDA) and ``--polygon``, saving its checkpoint; the
   report is ``metrics_flagship_bf16.json``;
3. the checkpoint's weights as a ``.pth`` with the reference's keys
   (``flagship.pth``, which ``compare_eval.py`` evaluates on the CPU);
4. the four rows (``host``, ``device``, ``host_poly``, ``device_poly``) of
   ``quality_bench.full_eval`` on the same test set through the plain
   model and through the BN-folded forward (bf16 float convs) and the
   int8 forward (static scales calibrated as ``quality_bench --quant``
   does), each plain, with ``stem_s2d``, with ``deconv_d2s`` and with both
   (``folded_rows.json``).

The card's name and power limit, the versions and each step's wall
seconds go to ``--out``; data and the checkpoint to ``--work`` (``tmp/``
by default, which git ignores)::

    python demo/port_vs_jax/card_rows.py --out chiprun_out/pvj
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

TRACE = "demo/hard_bench_torch/text_engine_hard_seed7.npz"
PKG = "db_text_minimal_tpu_torch"
FORMS = {"plain": {}, "s2d": {"stem_s2d": True},
         "d2s": {"deconv_d2s": True},
         "both": {"stem_s2d": True, "deconv_d2s": True}}


def pth_step(ckpt: str, pth: str) -> None:
    """The trained checkpoint's weights alone, reference keys."""
    import torch

    from db_text_minimal_tpu_torch.train.checkpoints import load_params_any

    sd = load_params_any(ckpt)
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, pth)


def rows_step(hb: str, pth: str, out: str, device: str) -> None:
    """``full_eval``'s four rows through the plain model and each form of
    the folded and int8 forwards."""
    import numpy as np

    from db_text_minimal_tpu_torch.cli import quality_bench as qb
    from db_text_minimal_tpu_torch.data import DataLoader, build_dataset
    from db_text_minimal_tpu_torch.models.head import fuse_variables
    from db_text_minimal_tpu_torch.models.quant_infer import (
        DEFAULT_SKIP, calibrate_activation_scales, prepare_quant_params,
        quant_dbnet_forward, tree_to)
    from db_text_minimal_tpu_torch.train.trainer import (Trainer,
                                                         device_preprocess)
    from db_text_minimal_tpu_torch.utils import CAFFE_MEAN

    args = qb.load_args(["--data_dir", hb, "--out", out, "--eval_only",
                         "--checkpoint", pth, "--polygon", "--device",
                         device])
    cfg = qb.build_cfg(args)
    test_loader = DataLoader(build_dataset(cfg, is_training=False),
                             int(cfg.hps.test_batch_size))
    trainer = Trainer(cfg, None, test_loader)
    state = trainer.resume_state(pth)
    sd = fuse_variables(state.model.state_dict())
    first = next(iter(test_loader))
    cal = np.asarray(first["img"]).astype(np.float32)
    if np.asarray(first["img"]).dtype == np.uint8:
        cal = cal - np.asarray(CAFFE_MEAN, np.float32)
    cal = cal[:2]
    report: dict = {}

    def row(name, forward=None):
        t0 = time.perf_counter()
        report[name] = qb.full_eval(trainer, state, test_loader, args,
                                    forward=forward)
        report[name]["eval_wall_s"] = round(time.perf_counter() - t0, 2)
        print(name, json.dumps(report[name]), flush=True)
        with open(out, "w") as f:
            json.dump(report, f, indent=1)

    row("model")
    for mode in ("folded", "int8"):
        for form, flags in FORMS.items():
            kw = ({"min_out_channels": 10 ** 9} if mode == "folded"
                  else {"skip": DEFAULT_SKIP})
            qv = tree_to(prepare_quant_params(sd, **kw, **flags),
                         trainer.device)
            if mode == "int8":
                qv = calibrate_activation_scales(qv, [cal])

            def forward(device_batch, qv=qv):
                return quant_dbnet_forward(
                    qv, device_preprocess(device_batch)["img"])

            row(f"{mode}_{form}", forward)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True)
    parser.add_argument("--work", default="tmp/port_vs_jax")
    parser.add_argument("--step", choices=("pth", "rows"), default=None,
                        help="run one step in this process (internal)")
    parser.add_argument("--epochs", default="10")
    parser.add_argument("--device", default="cuda",
                        help="where --step rows evaluates")
    args = parser.parse_args()
    hb = os.path.join(args.work, "hb")
    ckpt = os.path.join(args.work, "flagship.ckpt")
    pth = os.path.join(args.out, "flagship.pth")
    if args.step == "pth":
        pth_step(ckpt, pth)
        return 0
    if args.step == "rows":
        rows_step(hb, pth, os.path.join(args.out, "folded_rows.json"),
                  args.device)
        return 0
    os.makedirs(args.out, exist_ok=True)
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
    me = [sys.executable, __file__, "--out", args.out, "--work", args.work]
    run("make_synthetic", py + [f"{PKG}.cli.make_synthetic", hb, "--hard",
                                "--text_trace", TRACE])
    run("metrics_flagship_bf16", py + [
        f"{PKG}.cli.quality_bench", "--data_dir", hb, "--out",
        os.path.join(args.out, "metrics_flagship_bf16.json"), "--epochs",
        args.epochs, "--batch_size", "16", "--lr", "0.005", "--reduction",
        "none", "--polygon", "--save_checkpoint", ckpt])
    run("pth", me + ["--step", "pth"])
    run("folded_rows", me + ["--step", "rows"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
