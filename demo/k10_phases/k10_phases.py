#!/usr/bin/env python3
"""Where K10's select spends its time on an NVIDIA GPU, phase by phase.

Run from the repository root on a machine with the card::

    python demo/k10_phases/k10_phases.py [--out DIR]

It writes a copy of ``db_text_minimal_tpu_torch/csrc/ohem.cu`` in which
thread 0 of each block reads ``%globaltimer`` at each phase boundary of
``k10_select`` (a ``__syncthreads`` first, so each stamp is the block's
end of that phase; the load's stamp is thread 0's wait for the last
chunk), builds it with nvcc, and runs it on the loss map of a seeded
model's bf16 train-mode forward at batch 16, 640x640
(``chip_smoke.step_inputs``), on maps of its size with clamped-BCE ties
and of four values, and on a 32x640x640 map, each call after the 256 MB
L2 flush of ``chip_smoke.flush_l2``. It holds lo to the bisection's, and
prints one JSON line a map: the median over 8 calls of each phase's end,
in microseconds from the first block's start, the slowest block's (the
load's: its spread over the blocks), and the card's time per call of the
uninstrumented kernel from torch.profiler. The stamps' barriers and
stores cost a little; the phase ends are read against each other, and
the uninstrumented time is the one to quote.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

PHASES = ["start", "zeroed", "pass 0", "pass 0 merged", "pass 0 picked",
          "pass 1", "pass 1 merged", "pass 1 picked", "pass 2",
          "pass 2 merged", "pass 2 picked", "replayed", "summed", "end",
          "loaded", "list"]
STAMP = ("{ unsigned long long t_; asm volatile(\"mov.u64 %0, "
         "%%globaltimer;\" : \"=l\"(t_)); g_stamps[blockIdx.x * 16 + (I)] "
         "= t_; }")


def stamped_source(src: str) -> str:
    """The kernel's source with a stamp at each phase boundary."""
    def at(after: str, text: str) -> None:
        nonlocal src
        if src.count(after) != 1:
            raise RuntimeError(f"the kernel changed: {after!r}")
        src = src.replace(after, after + text)

    def stamp(i: int, sync: bool = True) -> str:
        body = STAMP.replace("(I)", f"({i})")
        return (("  __syncthreads();\n" if sync else "")
                + f"  if (threadIdx.x == 0) {body}\n")

    at("namespace cg = cooperative_groups;\n",
       "__device__ unsigned long long g_stamps[1024 * 16];\n")
    at("  cg::grid_group grid = cg::this_grid();\n", stamp(0))
    at("    zeroed[i] = 0;\n  __syncthreads();\n", stamp(1, False))
    at("    if (threadIdx.x == 0) target_rank(kv, sl.n, sh);\n  }\n",
       stamp(2).replace("(2)", "(2 + 3 * PASS)"))
    at("  if (PASS == 0 && threadIdx.x == 0) sh->max_key = "
       "__ldcg(&st->max_key);\n",
       stamp(3).replace("(3)", "(3 + 3 * PASS)"))
    at("  if (sh->mode == 0) pick_bucket<PASS>(st->hist[PASS], sh);\n"
       "  __syncthreads();\n", stamp(4).replace("(4)", "(4 + 3 * PASS)"))
    at("    sh->lo = lo;\n  }\n  __syncthreads();\n", stamp(11))
    at("    list_len = build_list(data, len, value_of(kmin0), sh);\n",
       "  " + stamp(15).replace("\n  ", "\n    "))
    at("    if (wait) wait_stage(bar + c);\n",
       "    if (wait && threadIdx.x == 0 && (c + 1) * CHUNK >= len) "
       + STAMP.replace("(I)", "(14)") + "\n")
    at("  if (threadIdx.x == 0) {\n    st->part_sum[blockIdx.x] = sum;\n",
       "    " + STAMP.replace("(I)", "(12)") + "\n")
    at("    *lo_out = lo;\n", "    " + STAMP.replace("(I)", "(13)") + "\n")
    at('extern "C" {\n',
       "int read_stamps(void* host) { return (int)cudaMemcpyFromSymbol("
       "host, g_stamps, sizeof(g_stamps)); }\n")
    return src


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the lines to DIR/phases.jsonl")
    args = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k10_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from db_text_minimal_tpu_torch.ops import ohem as OH
    from db_text_minimal_tpu_torch.ops._native import (CSRC, _find_nvcc,
                                                       stream_of)

    work = tempfile.mkdtemp()
    cu = os.path.join(work, "ohem_stamped.cu")
    with open(os.path.join(CSRC, "ohem.cu")) as f:
        src = f.read()
    with open(cu, "w") as f:
        f.write(stamped_source(src))
    so = os.path.join(work, "libohem_stamped.so")
    subprocess.run([_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ohem_state_bytes.restype = q
    lib.ohem_topk_sum.argtypes = [p, q, p, p, i, p, p, p]
    lib.read_stamps.argtypes = [p]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)

    _, _, values, k = S.step_inputs()
    n = values.numel()
    gen = np.random.RandomState(S.SEED)
    clamped = torch.from_numpy(np.where(
        gen.rand(n) < 0.3, -np.log(np.float32(1e-7)), gen.rand(n) * 2.0)
        .astype(np.float32)).cuda() * (values.view(-1) > 0)
    four = torch.from_numpy(gen.choice(np.float32([0.0, 0.1053, 0.6931,
                                                   16.118]), n)).cuda()
    maps = [("loss", values, k), ("clamped", clamped, k),
            ("four values", four, k),
            ("32x640x640", torch.cat([values.view(-1), clamped]), 2 * k)]
    state = torch.empty(lib.ohem_state_bytes(), dtype=torch.uint8,
                        device="cuda")
    out, lo = (torch.empty((), device="cuda") for _ in range(2))
    host = np.zeros(1024 * 16, np.uint64)
    lines = []
    for name, v, kv in maps:
        rows, spread = [], []
        for rep in range(10):
            S.flush_l2()
            torch.cuda.synchronize()
            host[:] = 0
            err = lib.ohem_topk_sum(v.data_ptr(), v.numel(), kv.data_ptr(),
                                    state.data_ptr(), OH.ITERS,
                                    out.data_ptr(), lo.data_ptr(),
                                    stream_of(v))
            if err:
                raise RuntimeError(f"k10_select: CUDA error {err}")
            torch.cuda.synchronize()
            lib.read_stamps(host.ctypes.data)
            st = host.reshape(1024, 16).astype(np.int64)
            used = st[:, 0] > 0
            st = st[used]
            t0 = st[:, 0].min()
            ends = [float(st[:, j].max() - t0) / 1e3 for j in range(16)]
            ends[13] = float(st[:, 13].max() - t0) / 1e3
            if rep >= 2:
                rows.append(ends)
                spread.append(float(st[:, 14].min() - t0) / 1e3)
        if not torch.equal(lo, OH.bisection_lo(v, kv)):
            raise AssertionError(f"k10_phases {name}: lo differs")
        device_ms, _, ops = S.device_kernels(
            lambda: OH.topk_select(v, kv), 20)
        med = np.median(np.array(rows), axis=0)
        line = {"map": name, "n": v.numel(), "device_ms": device_ms,
                "device_ops": ops, "card": smi,
                "phase_end_us": {ph: float(x) for ph, x in zip(PHASES, med)},
                "first_block_loaded_us": float(np.median(spread))}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "phases.jsonl"), "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
