"""Builds the port's native libraries from the sources in the checkout.

Each library is compiled at first use into ``BUILD_DIR`` (listed in
``.gitignore``) and rebuilt when its source is newer. A build writes to a
temporary name and renames it into place, so concurrent processes never load
a half-written file. The compiler's output is kept beside the library as
``<name>.log``. The launch helpers below are shared by the kernel modules
that bind these libraries.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
CSRC = os.path.join(_PKG, "csrc")


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def build_library(src: str, name: str, kind: str) -> str:
    """Compile ``src`` into ``BUILD_DIR/<name>.so`` unless an up-to-date
    build is there; returns the library's path. ``kind`` is ``"cuda"``
    (nvcc for sm_90a) or ``"cxx"`` (g++)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, name + ".so")
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        return out
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    if kind == "cuda":
        cmd = [_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, src]
    elif kind == "cxx":
        # -march=native as the JAX package builds its copy: with FMA the
        # compiler contracts a*b+c, which moves Douglas-Peucker's distance
        # tests by an ulp, enough to keep or drop a vertex on a tie
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-std=c++17", src, "-o", tmp]
    else:
        raise ValueError(f"unknown library kind {kind!r}")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, name + ".log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {src} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("inputs lie on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"inputs must all lie on one CUDA device or on the "
                     f"CPU, got {sorted(kinds)}")


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
