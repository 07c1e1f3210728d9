#!/usr/bin/env python3
"""Readings of a cell's correctness numbers over many seeds, in one
process: what the limits in ``portbench/checks/`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --modes program,control[,half] [--out FILE]

``program`` reads the timed path as a run reads it (the checked steps of a
training cell; for a serving cell one call of each pool batch after a
warm-up); ``control`` puts the configuration's lower precision in the
program's place (training: the reference with every conv in int8;
serving: the port's own int8 forward, ``infer_mode="int8"``); ``fp8``
(training) the reference with every conv in float8; ``half`` (training)
the reference on half of each batch. Two witnesses of a
training cell: ``program32``, the port training in float32 (TF32 off),
and ``bf16ref``, the reference with every conv rounded to bfloat16 both
ways. Each (seed, mode) prints one JSON line, with each parameter's
norms for a training cell, and is appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.run import set_caches  # noqa: E402


def train_readings(ctx, seed: int, modes: list) -> list:
    import torch

    from portbench.core import compare, train_cell as TC
    from portbench.core import traffic as TG, weights as W
    from portbench.reference import model as M

    cfg, t, dev = ctx.config, ctx.traffic, ctx.device
    n = compare.CHECK_STEPS
    host = TG.make_pool(t, seed, ctx.workers)[:n]
    weights = W.make(cfg, seed, dev)
    ref = TC.reference_steps(cfg, weights, host, dev)
    rows = []
    for mode in modes:
        t0 = time.perf_counter()
        if mode in ("program", "program32"):
            pc = dict(cfg, train_dtype="float32") if mode == "program32" \
                else cfg
            prog = ctx.program_factory(pc, t, weights, dev)
            pool = TC.pin(host) if dev.type == "cuda" else [
                {k: torch.from_numpy(v) for k, v in b.items()} for b in host]
            got = TC.checked_steps(prog, pool, weights)
            del prog, pool
            TC.free()
        elif mode == "control":
            got = TC.reference_steps(cfg, weights, host, dev,
                                     ops=M.Int8Ops("train"))
        elif mode == "fp8":
            got = TC.reference_steps(cfg, weights, host, dev,
                                     ops=M.Fp8Ops("train"))
        elif mode == "bf16ref":
            got = TC.reference_steps(cfg, weights, host, dev,
                                     ops=M.Bf16Ops("train"))
        elif mode == "half":
            got = TC.reference_steps(cfg, weights, host, dev,
                                     rows=t["batch"] // 2)
        else:
            raise ValueError(mode)
        numbers, details = compare.train_readings(got, ref)
        rows.append({"seed": seed, "mode": mode, "numbers": numbers,
                     "details": details,
                     "leaves": {"grad": got["grad_norms"],
                                "ref_grad": ref["grad_norms"],
                                "update": got["update_norms"],
                                "ref_update": ref["update_norms"],
                                "losses": got["losses"],
                                "ref_losses": ref["losses"]},
                     "seconds": time.perf_counter() - t0})
    return rows


def serve_readings(ctx, seed: int, modes: list) -> list:
    from portbench.core import serve_cell as SC
    from portbench.core import traffic as TG

    cfg, t, dev = ctx.config, ctx.traffic, ctx.device
    pool = TG.make_pool(t, seed, ctx.workers)
    weights = SC.serve_weights(cfg, seed, pool[0], dev)
    rows = []
    for mode in modes:
        t0 = time.perf_counter()
        infer_mode = {"program": None, "control": "int8"}[mode]
        server = SC.ProgramServer(cfg, t, weights, dev,
                                  infer_mode=infer_mode)
        warm = t["warmup_calls"]
        SC.calls(server, pool, 0, count=warm)
        kept = SC.calls(server, pool, warm, count=len(pool),
                        keep={j: 0 for j in range(len(pool))})["kept"]
        del server
        SC.free()
        numbers = SC.serve_readings(cfg, weights, pool, kept, dev)
        rows.append({"seed": seed, "mode": mode, "numbers": numbers,
                     "seconds": time.perf_counter() - t0})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program,control")
    p.add_argument("--out")
    args = p.parse_args(argv)
    set_caches()
    from portbench.core import harness
    from portbench.core.registry import Registry

    reg = Registry(ROOT)
    ctx = harness.make_context(reg, args.workload, 0, 0.0, False,
                               time.time(), "cuda")
    fn = (train_readings if ctx.traffic["kind"] == "train"
          else serve_readings)
    modes = args.modes.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in fn(ctx, seed, modes):
            row["workload"] = args.workload
            line = json.dumps(row)
            print(json.dumps({k: v for k, v in row.items()
                              if k != "leaves"}), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
