"""K10: OHEM's top-k sum with a dynamic k, without a sort.

Port of the TPU-shaped op ``_topk_sum`` of
``db_text_minimal_tpu/losses.py:40-67``: the sum of the ``k`` largest
entries of a non-negative f32 map, ``k`` a 0-d f32 tensor, as a bisection
of 34 rounds for the k-th largest value t on the bracket ±max(max, 1) with
``count(values > mid) >= k``, then the tie-corrected sum
Σ values·[values > t] + t·(k − count(values > t)). The gradient is 1 on the
selected entries and t is a constant, JAX's stop-gradient rule (:66).

``topk_sum_plain`` is that bisection in PyTorch, a compare, a count, a
compare with k, two ``torch.where`` and the midpoint a round: ~320 device
operations a call on the card. The kernels of
``csrc/ohem.cu`` replace it on CUDA tensors: a radix select of the kk-th
largest value v (kk the least integer c with float32(c) >= k, as the
f32-rounded count is compared with k), a replay of the 34 rounds against v
in one thread (a round keeps lo exactly when mid < v), which gives the
bisection's lo bit for bit, and one pass for the sum and the count above
lo, the sum and the tie correction taken in f64; a memset and four
launches, no value read back to the host.
The backward is one more kernel, g·[values > lo].

The functions ``order_keys``, ``target_rank``, ``radix_select`` and
``replay`` are the kernels' steps written out in numpy, one thread's view,
so that the CPU tests can hold them to the bisection on the edge cases
(ties at v, k = 0, k past the count, k past 2**24).

On CUDA tensors ``topk_sum`` launches the kernels, counts them in
``LAUNCHES`` and raises if they do not build or launch; on CPU tensors it
runs ``topk_sum_plain``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from ._native import CSRC, build_library, check_launch, on_cuda, stream_of

LAUNCHES = {"ohem_topk_sum": 0, "ohem_topk_grad": 0}
ITERS = 34
# the radix select's digits, high first: (shift, bits)
DIGITS = ((21, 11), (10, 11), (0, 10))

_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_library() -> ctypes.CDLL:
    """Build ``csrc/ohem.cu`` (first call only) and bind its C entries."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library(os.path.join(CSRC, "ohem.cu"),
                                            "libohem", "cuda"))
            p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ohem_state_bytes.argtypes = []
            lib.ohem_state_bytes.restype = q
            lib.ohem_topk_sum.argtypes = [p, q, i, p, p, i, i, p, p, p]
            lib.ohem_topk_sum.restype = i
            lib.ohem_topk_grad.argtypes = [p, q, p, p, p, i, p]
            lib.ohem_topk_grad.restype = i
            _LIB = lib
    return _LIB


# ------------------------------------------------------------ plain ----

def bisection_lo(values: torch.Tensor, k: torch.Tensor,
                 iters: int = ITERS) -> torch.Tensor:
    """The bisection's lower end after ``iters`` rounds: the k-th largest
    value of ``values``, from below (a 0-d tensor)."""
    sg = values.detach()
    hi = torch.clamp(sg.max(), min=1.0)
    lo = -1.0 * hi
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        keep_lo = (sg > mid).sum() >= k
        lo, hi = torch.where(keep_lo, mid, lo), torch.where(keep_lo, hi, mid)
    return lo


def topk_sum_plain(values: torch.Tensor, k: torch.Tensor,
                   iters: int = ITERS) -> torch.Tensor:
    """Sum of the ``k`` largest entries of a non-negative map, ``k`` a 0-d
    f32 tensor. Bisects for the k-th largest value t on the bracket
    ±max(max, 1) with ``count(values > mid) >= k``, then takes the
    tie-corrected sum Σ values·[values > t] + t·(k − count(values > t)),
    ties at t counted fractionally. The gradient is 1 on the selected
    entries; t is detached."""
    lo = bisection_lo(values, k, iters)
    above = (values.detach() > lo).to(values.dtype)
    cnt = above.sum()
    return (values * above).sum() + lo * (k - cnt)


def sum_scale(values: torch.Tensor, lo: torch.Tensor,
              k: torch.Tensor) -> float:
    """|Σ values·[values > lo]| + |lo·(k − count(values > lo))|: the size of
    the two terms whose sum the top-k sum is. They cancel where many values
    tie at lo, so any two orders of summing them (f32 against f64) differ
    by a share of this, not of the result."""
    above = (values > lo).to(torch.float32)
    return (abs((values * above).sum().item())
            + abs((lo * (k - above.sum())).item()))


# ------------------------------------------- the kernels' steps, numpy ----

def order_keys(values: np.ndarray) -> np.ndarray:
    """uint32 keys in the order of the f32 values (-0 as +0)."""
    v = np.asarray(values, np.float32).ravel()
    u = np.where(v == 0, np.float32(0), v).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def key_value(key: int) -> np.float32:
    u = key & 0x7FFFFFFF if key & 0x80000000 else ~key & 0xFFFFFFFF
    return np.array([u], np.uint32).view(np.float32)[0]


def target_rank(k: float, n: int) -> int:
    """kk, the least integer c >= 0 with float32(c) >= k: 0 when every
    round keeps lo, n + 1 when none does (k past float32(n), or NaN)."""
    k = np.float32(k)
    if k <= 0:
        return 0
    if not k <= np.float32(n):
        return n + 1
    c = int(np.ceil(k))
    while c > 0 and np.float32(c - 1) >= k:
        c -= 1
    return c


def radix_select(keys: np.ndarray, kk: int) -> int:
    """The kk-th largest key (1 <= kk <= len(keys)) by the kernels' three
    digit passes: each histograms one digit of the keys under the chosen
    prefix and takes the bucket that holds the rank, high bins first."""
    keys = np.asarray(keys, np.uint32)
    prefix, rank = 0, kk
    for pass_, (shift, bits) in enumerate(DIGITS):
        under = (keys if pass_ == 0
                 else keys[(keys >> np.uint32(shift + bits)) == prefix])
        hist = np.bincount((under >> np.uint32(shift))
                           & np.uint32((1 << bits) - 1),
                           minlength=1 << bits)
        above = np.concatenate([np.cumsum(hist[::-1])[::-1][1:], [0]])
        digit = int(np.nonzero((above < rank) & (rank <= above + hist))[0][0])
        prefix = (prefix << bits) | digit if pass_ else digit
        rank -= int(above[digit])
    return prefix


def replay(max_value: float, v: float | None, kk: int, n: int,
           iters: int = ITERS) -> np.float32:
    """The bisection's lo replayed in one thread: a round keeps lo exactly
    when mid < v, the kk-th largest value (every round when kk <= 0, none
    when kk > n)."""
    hi = np.maximum(np.float32(max_value), np.float32(1.0))
    lo = np.float32(-1.0) * hi
    for _ in range(iters):
        mid = np.float32(0.5) * (lo + hi)
        keep = kk <= 0 or (kk <= n and mid < v)
        lo, hi = (mid, hi) if keep else (lo, mid)
    return lo


def select_lo(values: np.ndarray, k: float, iters: int = ITERS
              ) -> np.float32:
    """lo as the kernels compute it, from the values alone."""
    keys = order_keys(values)
    kk = target_rank(k, keys.size)
    v = key_value(radix_select(keys, kk)) if 1 <= kk <= keys.size else None
    return replay(key_value(int(keys.max())), v, kk, keys.size, iters)


# ---------------------------------------------------------- kernels ----

def _blocks(device: torch.device) -> int:
    """Four blocks of 512 threads an SM: the grid-stride kernels' grid."""
    return 4 * torch.cuda.get_device_properties(device).multi_processor_count


def topk_select(values: torch.Tensor, k: torch.Tensor, iters: int = ITERS
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k sum and the bisection's lo, both 0-d f32, of a contiguous
    f32 map on the card, by the kernels: a memset and four launches."""
    on_cuda(values, k)
    n = values.numel()
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"the select takes 1 to 2**31 - 1 values, got {n}")
    lib = load_library()
    state = torch.zeros(lib.ohem_state_bytes(), dtype=torch.uint8,
                        device=values.device)
    out = torch.empty((), dtype=torch.float32, device=values.device)
    lo = torch.empty_like(out)
    err = lib.ohem_topk_sum(values.data_ptr(), n,
                            int(values.data_ptr() % 16 == 0), k.data_ptr(),
                            state.data_ptr(), _blocks(values.device), iters,
                            out.data_ptr(), lo.data_ptr(), stream_of(values))
    check_launch(err, "ohem_topk_sum")
    LAUNCHES["ohem_topk_sum"] += 1
    return out, lo


def topk_grad(values: torch.Tensor, lo: torch.Tensor, g: torch.Tensor
              ) -> torch.Tensor:
    """g·[values > lo] by one kernel, for a contiguous f32 map on the card
    and 0-d f32 ``lo`` and ``g``."""
    on_cuda(values, lo, g)
    dx = torch.empty_like(values)
    err = load_library().ohem_topk_grad(
        values.data_ptr(), values.numel(), lo.data_ptr(), g.data_ptr(),
        dx.data_ptr(), _blocks(values.device), stream_of(values))
    check_launch(err, "ohem_topk_grad")
    LAUNCHES["ohem_topk_grad"] += 1
    return dx


class _TopkSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, k, iters):
        out, lo = topk_select(values, k, iters)
        ctx.save_for_backward(values, lo)
        return out

    @staticmethod
    def backward(ctx, g):
        values, lo = ctx.saved_tensors
        dvalues = dk = None
        if ctx.needs_input_grad[0]:
            dvalues = topk_grad(values, lo, g.contiguous())
        if ctx.needs_input_grad[1]:
            dk = g * lo
        return dvalues, dk, None


def topk_sum(values: torch.Tensor, k: torch.Tensor,
             iters: int = ITERS) -> torch.Tensor:
    """Sum of the ``k`` largest entries of the non-negative f32 map
    ``values``, ``k`` a 0-d f32 tensor on its device: K10's kernels on CUDA
    tensors, ``topk_sum_plain`` on CPU ones. Differentiable in ``values``
    (1 on the selected entries)."""
    if not on_cuda(values, k):
        return topk_sum_plain(values, k, iters)
    if values.dtype != torch.float32 or k.dtype != torch.float32 or k.dim():
        raise TypeError(f"the top-k sum takes an f32 map and a 0-d f32 k, "
                        f"got {values.dtype} and {k.dtype} {tuple(k.shape)}")
    return _TopkSum.apply(values.contiguous(), k, int(iters))
