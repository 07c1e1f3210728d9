#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``db_text_minimal_tpu_torch``), on a machine with as many
CUDA cards as the cell asks for. The last line of standard output is the
result, one JSON object; the last lines of standard error name each number
compared beside its limit. Build and kernel caches stay inside the
checkout: the port's nvcc libraries in its ``build/``, Triton's cache in
``portbench/.cache/``.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / ".cache"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def set_caches() -> None:
    """Fixed cache directories inside the checkout, before anything that
    reads them is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_caches()
    import torch

    phases = {"import_torch": time.time() - T_START}
    from portbench.core import harness
    from portbench.core.registry import Registry

    reg = Registry(ROOT)
    chips = reg.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"found {n}", file=sys.stderr)
        return 2
    phases["find_cards"] = time.time() - T_START
    ctx = harness.make_context(reg, args.workload, args.seed, args.seconds,
                               bool(args.trace), T_START, "cuda")
    ctx.phases.update(phases)
    result, lines = harness.run_cell(reg, ctx)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{loaded}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
