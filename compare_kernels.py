#!/usr/bin/env python3
"""Time chosen device kernels of two checkouts in turns on one NVIDIA GPU.

Run from the repository root, with another checkout of the repository
(for example the parent commit, unpacked by ``git archive``)::

    python3 compare_kernels.py OTHER_CHECKOUT [--kernels k4,k6,k5,k7,k10] [--turns 2]

The kernels are K4 (``ops/cc.compact_slots``, on the 8-connected
foreground's labels), K6 (``ops/cc.hole_stats``), K5
(``ops/cc.rotated_boxes``) and K7: its stats (``ops/cc.bbox_stats``, and
``ops/cc.poly_stats`` where the checkout has it) and its bit-pack
(``ops/cc.pack_bits``, on the 640-wide mask and on its 100x100 corner);
K10 is OHEM's top-k select (``ops/ohem.topk_select``) on the loss map of
a seeded model's bf16 train-mode forward at batch 16, 640x640
(``chip_smoke.step_inputs``), on maps of the same size with clamped-BCE
ties and of four values, and on a 32x640x640 map (the loss map and the
clamped map one after the other), each held to the bisection (lo
bit-equal, the sum within 1e-5 of its two terms' size).
The runs alternate, the other checkout first:
other, this, this, other, ... Each run is a process of its own, started in
the root of its checkout, so that it imports that checkout's package and
``chip_smoke.py`` and builds that checkout's kernels. A run makes each
kernel's inputs by that checkout's kernels (K3 -> K4 on the foreground, K3
-> K4 on the 4-connected background -> K6 -> K5) on the 8 kernel scenes of
``chip_smoke.py`` and on the maps of the batch it serves (its
``phase_serve``, weights from the seed), holds each chosen kernel to its
plain version (K4 exact, K6's counts exact and sums within 1e-6, K5's
valid slots exact; K7's counts, bboxes, valid flags and packed bytes
exact, its prob sums within 1e-9 of their size and scores within 1e-6),
and prints one line ``KTIME {json}``: per input and kernel the card's time
per call from torch.profiler, split by launch, and the time per call from
CUDA events; and the card's time per call of ``device_boxes`` and
``device_poly_stats`` on each input, with the device operations (kernels,
memsets, copies) a call of each. With k7, ``device_poly_stats`` on the card
is also held to the same call on the CPU on the kernel scenes (packed map,
bboxes and valid exact, scores within 1e-6; the served maps' one
checkerboard component takes the CPU too long). Exits non-zero when no GPU is available or a
run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

KERNELS = ("k4", "k6", "k5", "k7", "k10")
# the rows that k7 stands for; poly_stats only where the checkout has it
K7_ROWS = ("bbox_stats", "poly_stats", "pack_bits", "pack_bits_w100")


def hold(kernel: str, got, ref, label: str) -> float:
    """A kernel's result against its plain version's; returns its error."""
    import torch

    if kernel == "bbox_stats":
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])):
            raise AssertionError(f"{label}: counts or bboxes differ")
        err = (got[1] - ref[1]).abs().max().item() if ref[1].numel() else 0.0
        if err > 1e-9 * max(1.0, ref[1].abs().max().item()):
            raise AssertionError(f"{label}: prob sums {err} apart")
        return err
    if kernel in ("poly_stats", "device_poly_stats"):
        idx = (0, 2) if kernel == "poly_stats" else (0, 1, 3)
        if not all(torch.equal(got[i], ref[i]) for i in idx):
            raise AssertionError(f"{label}: bboxes, valid or bits differ")
        at = 1 if kernel == "poly_stats" else 2
        err = (got[at] - ref[at]).abs().max().item()
        if err > 1e-6:
            raise AssertionError(f"{label}: scores {err} apart")
        return err
    if kernel.startswith("pack_bits"):
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: packed bytes differ")
        return 0.0
    if kernel == "k4":
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"{label}: slots differ")
        return 0.0
    if kernel == "k6":
        if not torch.equal(got[1], ref[1]):
            raise AssertionError(f"{label}: hole counts differ")
        err = (got[0] - ref[0]).abs().max().item() if ref[0].numel() else 0.0
        if err > 1e-6 * max(1.0, ref[0].abs().max().item()):
            raise AssertionError(f"{label}: hole sums {err} apart")
        return err
    valid = ref[3]
    if not torch.equal(got[3], valid):
        raise AssertionError(f"{label}: valid slots differ")
    return max((got[i] - ref[i])[valid].abs().max().item()
               if valid.any() else 0.0 for i in (0, 1))


def device_ops(fn, reps: int) -> tuple[float, float]:
    """The card's time per call of ``fn`` in ms and its device operations
    (kernels, memsets, copies) per call, from torch.profiler over ``reps``
    calls after one warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler saw no device activity")
    return (sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps,
            len(events) / reps)


def k10_maps(S, values, k) -> dict:
    """K10's inputs: the step's loss map and k, maps of its size with
    clamped-BCE ties (30 % at -log(1e-7) where the loss map is nonzero)
    and of four values, and a 32x640x640 map."""
    import numpy as np
    import torch

    n = values.numel()
    gen = np.random.RandomState(S.SEED)
    clamped = torch.from_numpy(np.where(
        gen.rand(n) < 0.3, -np.log(np.float32(1e-7)), gen.rand(n) * 2.0)
        .astype(np.float32)).cuda() * (values.view(-1) > 0)
    four = torch.from_numpy(gen.choice(np.float32([0.0, 0.1053, 0.6931,
                                                   16.118]), n)).cuda()
    return {"loss": (values, k), "clamped": (clamped, k),
            "four values": (four, k),
            "32x640x640": (torch.cat([values.view(-1), clamped]), 2 * k)}


def measure_k10(S) -> dict:
    """K10's select on each of ``k10_maps``: its error against the
    bisection, the card's time per call and its split by launch from
    torch.profiler, device operations a call, and the time per call from
    CUDA events, each call after an L2 flush."""
    from db_text_minimal_tpu_torch.ops import ohem as OH

    out = {}
    for name, (v, kv) in k10_maps(S, *S.step_inputs()[2:]).items():
        got, lo = OH.topk_select(v, kv)
        lo_p = OH.bisection_lo(v, kv)
        if not bool((lo == lo_p).item()):
            raise AssertionError(f"k10 {name}: lo {lo.item()!r} against "
                                 f"{lo_p.item()!r}")
        err = abs(got.item() - OH.topk_sum_plain(v, kv).item())
        if not err <= 1e-5 * OH.sum_scale(v, lo_p, kv):
            raise AssertionError(f"k10 {name}: sum {err} apart")
        dev_ms, split, ops = S.device_kernels(lambda: OH.topk_select(v, kv),
                                              50)
        out[name] = {"n": v.numel(), "err": err, "device_ms": dev_ms,
                     "device_ops": ops,
                     "ms": S.timed(lambda: OH.topk_select(v, kv), 50),
                     "split": {S.short_name(key): ms
                               for key, ms in split.items()}}
    return out


def measure(label: str, kernels: list[str]) -> dict:
    """The chosen kernels of the checkout in the working directory, on
    both inputs."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as S
    from db_text_minimal_tpu_torch.ops import cc

    out = {"label": label, "root": os.getcwd()}
    if "k10" in kernels:
        out["k10"] = measure_k10(S)
    if not set(kernels) - {"k10"}:
        return out
    dev = torch.device("cuda")
    cc.load_library()
    scenes = torch.from_numpy(
        np.stack([S.kernel_scene(i) for i in range(S.N)])).to(dev)
    with tempfile.TemporaryDirectory() as workdir:
        _, _, preds, _ = S.phase_serve(workdir)
    for name, prob in (("scenes", scenes), ("served",
                                            preds[..., 0].contiguous())):
        mask = prob > 0.3
        labels = cc.connected_components(mask)
        keyed, valid_root = cc.compact_slots(labels, S.K)
        bg_keyed, _ = cc.compact_slots(cc.connected_components(~mask, 4),
                                       S.K)
        hole = cc.hole_stats(mask, keyed, bg_keyed, prob, S.K)
        corner = mask[:, :100, :100].contiguous()
        calls = {
            "k4": ((labels, S.K), cc.compact_slots, cc.compact_slots_plain),
            "k6": ((mask, keyed, bg_keyed, prob, S.K), cc.hole_stats,
                   cc.hole_stats_plain),
            "k5": ((prob, keyed, valid_root) + hole + (S.K,),
                   cc.rotated_boxes, cc.rotated_boxes_plain),
            "bbox_stats": ((keyed, prob, S.K), cc.bbox_stats,
                           cc.bbox_stats_plain),
            "pack_bits": ((mask,), cc.pack_bits, cc.pack_bits_plain),
            "pack_bits_w100": ((corner,), cc.pack_bits, cc.pack_bits_plain)}
        if hasattr(cc, "poly_stats"):
            calls["poly_stats"] = ((keyed, valid_root, prob) + hole + (S.K,),
                                   cc.poly_stats, cc.poly_stats_plain)
        rows = [r for k in kernels
                for r in (K7_ROWS if k == "k7" else (k,)) if r in calls]
        out[name] = {}
        for row in rows:
            args, fn, plain = calls[row]
            err = hold(row, fn(*args), plain(*args),
                       f"{label}, {name}, {row}")
            dev_ms, split = S.device_kernels(lambda: fn(*args), 50)[:2]
            out[name][row] = {
                "err": err, "ms": S.timed(lambda: fn(*args), 50),
                "device_ms": dev_ms,
                "split": {S.short_name(k): v for k, v in split.items()}}
        for path in ("device_boxes", "device_poly_stats"):
            fn = getattr(cc, path)
            (out[name][f"{path}_device_ms"],
             out[name][f"{path}_ops"]) = device_ops(lambda: fn(prob), 20)
            if (path == "device_poly_stats" and "k7" in kernels
                    and name == "scenes"):
                got = [t.cpu() for t in fn(prob)]
                out[name]["device_poly_stats_err"] = hold(
                    path, got, fn(prob.cpu()), f"{label}, {name}, {path}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", nargs="?",
                        help="root of the checkout to compare with")
    parser.add_argument("--kernels", default="k4,k6,k5,k7",
                        help="comma-separated, of k4, k6, k5, k7, k10 "
                        "(default k4,k6,k5,k7)")
    parser.add_argument("--turns", type=int, default=2,
                        help="pairs of runs (default 2)")
    parser.add_argument("--one", metavar="LABEL",
                        help="measure the checkout in the working directory")
    args = parser.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    if not kernels or any(k not in KERNELS for k in kernels):
        parser.error(f"--kernels takes some of {','.join(KERNELS)}")
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print("KTIME " + json.dumps(measure(args.one, kernels)), flush=True)
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
                              "--one", label, "--kernels", ",".join(kernels)],
                             cwd=root)
        if run.returncode != 0:
            print(f"compare_kernels: the run of {root} failed",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
