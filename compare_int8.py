#!/usr/bin/env python3
"""Time the int8 serving path of two checkouts in turns on one NVIDIA GPU.

Run from the repository root, with another checkout of the repository (for
example the parent commit, unpacked by ``git archive``)::

    python3 compare_int8.py OTHER_CHECKOUT [--turns 2]

The runs alternate, the other checkout first: other, this, this, other,
... Each run is a process of its own, started in the root of its checkout,
so that it imports that checkout's package and ``chip_smoke.py`` and builds
that checkout's kernels. A run draws resnet18 + FPN + DB head weights from
``chip_smoke.SEED`` (as its serve phase does), serves ``chip_smoke``'s
batch of 8 synthetic 640x480 images through ``DBTextDetectionHandler`` in
"int8" mode (dynamic scales) and times, at batch 8: the prob-only int8
forward box mode runs (median of 11 by CUDA events), the same forward with
static scales calibrated on 2 images (``make_folded_forward``), and
``handle()``'s stages in box mode (``chip_smoke.serve_stages``: [q25,
median, q75] ms of preprocess, forward, box postprocess, total). Each
forward is profiled: the card's busy ms a forward, its top kernels by
device ms, and how many ``aten::_int_mm`` and ``aten::unfold`` calls it
makes. It prints one line ``I8TIME {json}`` a run, after the card's name
and power limit. Exits non-zero when no GPU is available or a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def measure(label: str) -> dict:
    """The int8 serving path of the checkout in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as S

    out = {"label": label, "root": os.getcwd()}
    with tempfile.TemporaryDirectory() as workdir:
        model = S.DBTextModel()
        model.reset_parameters(torch.Generator().manual_seed(S.SEED))
        pth = os.path.join(workdir, "dbnet_resnet18_seed.pth")
        torch.save(model.state_dict(), pth)
        handler = S.DBTextDetectionHandler(pth, infer_mode="int8")
        handler.initialize()
        request = [{"body": b} for b in S.synthetic_images()]
        batch_u8 = handler.preprocess(request)
        batch = torch.from_numpy(batch_u8).cuda().float() - torch.tensor(
            S.CAFFE_MEAN, device="cuda")
        static = S.make_folded_forward(
            S.load_state_dict(pth, fuse_head=True), quantize=True,
            calibration=[batch[:2]])
        handler.handle(request, mode="boxes")
        forwards = {
            "int8": lambda: handler.inference(batch_u8, prob_only=True),
            "int8_static": lambda: static(batch, prob_only=True)}
        for name, fn in forwards.items():
            ms = S.event_median(fn)
            busy, by_name, _ = S.device_kernels(fn, 3)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                fn()
                torch.cuda.synchronize()
            calls = [e.name for e in prof.events()]
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
            out[name] = {
                "forward_ms": ms, "busy_ms": busy,
                "int_mm_calls": calls.count("aten::_int_mm"),
                "unfold_calls": calls.count("aten::unfold"),
                "top_kernels_ms": {S.short_name(k)[:60]: v for k, v in top}}
        out["handle"] = S.serve_stages(handler, request)
        out["handle_img_s"] = S.N * 1e3 / out["handle"]["total"][1]
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
        print("compare_int8: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print("I8TIME " + json.dumps(measure(args.one)), flush=True)
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
            print(f"compare_int8: the run of {root} failed", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
