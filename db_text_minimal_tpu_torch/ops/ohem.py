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
operations a call on the card. On CUDA tensors the kernel ``k10_select``
of ``csrc/ohem.cu`` replaces it, one cooperative launch with no memset:
one block an SM copies its slice of the map into shared memory (bulk
copies; what does not fit is re-read from device memory), so the map
leaves device memory once, its least traffic (4 B a value: 0.0078 ms at
3.35 TB/s for a batch of 16 at 640x640). Over shared memory, a radix
select of the kk-th largest value v (kk the least integer c with
float32(c) >= k, as the f32-rounded count is compared with k) in three
digit passes, each thread adding a (bin, count) pair to its block's
histogram where its bin changes, the blocks' histograms merged, a grid
barrier, and every block picking the bucket itself; pass 1 first moves
the values at or above the pass-0 bucket to the front (the list), which
passes 1 and 2 read. Then a replay of the 34 rounds against v in one
thread (a round keeps lo exactly when mid < v), which gives the
bisection's lo bit for bit, and the sum and the count above lo over the
list (over the slice again when a value left out of the list may exceed
lo), the sum and the tie correction taken in f64, the blocks' sums added
in block order. No value is read back to the host. The backward is one
more kernel, g·[values > lo].

The functions ``order_keys``, ``target_rank``, ``radix_select`` and
``replay`` are the kernel's steps written out in numpy, one thread's view,
so that the CPU tests can hold them to the bisection on the edge cases
(ties at v, k = 0, k past the count, k past 2**24);
``cooperative_select`` is the whole launch written out: the blocks'
slices, the staged and the streamed words, each thread's runs and
flushes, the lists, the merged bins and each block's pick.

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
# k10_select's block: its threads, each taking RUN consecutive values of
# every chunk of RUN * THREADS (one mbarrier a chunk in shared memory)
THREADS = 1024
RUN = 11

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
            lib.ohem_topk_sum.argtypes = [p, q, p, p, i, p, p, p]
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


def pick_bucket(hist: np.ndarray, rank: int) -> tuple[int, int]:
    """The bucket of the rank-th largest key in a digit's merged bins, as
    a block of the kernel finds it: each of its THREADS threads sums
    bins / THREADS of the bins, high bins first, a scan over the threads
    finds the thread whose bins hold the rank, and it walks them. Returns
    the digit and the rank left within its bucket."""
    per = hist.size // THREADS
    own = hist[::-1].reshape(THREADS, per).sum(axis=1)
    incl = np.cumsum(own)
    t = int(np.nonzero((incl - own < rank) & (rank <= incl))[0][0])
    above = int(incl[t] - own[t])
    for i in range(per):
        digit = hist.size - 1 - t * per - i
        if rank <= above + int(hist[digit]):
            return digit, rank - above
        above += int(hist[digit])
    raise AssertionError("the rank lies past the bins")


def block_slices(n: int, head: int, blocks: int, cap4: int,
                 threads: int = THREADS, run: int = RUN) -> list[dict]:
    """Each block's share of ``k10_select``'s sweeps. ``head`` is the count
    of values before the first 16-byte boundary (the map's start modulo
    16, over 4). The aligned body's 16-byte words are split evenly over
    the blocks; a block stages the first ``cap4`` of its words in shared
    memory, in chunks of ``run * threads`` values of which a thread takes
    ``run`` consecutive ones (``staged``, in shared-memory order, and
    ``staged_owner``); it reads the rest from device memory in every
    sweep, a word a thread by a block stride, and block 0's thread 0 the
    head and the tail (``rest``, ``rest_owner``)."""
    head = min(head, n)
    words = (n - head) // 4
    per, extra = divmod(words, blocks)
    out = []
    for b in range(blocks):
        own = per + (b < extra)
        start4 = b * per + min(b, extra)
        staged4 = min(own, cap4)
        i = np.arange(4 * staged4)
        j = np.arange(4 * (own - staged4))
        ends = (np.r_[np.arange(head), np.arange(head + 4 * words, n)]
                if b == 0 else np.zeros(0, np.int64))
        out.append({
            "staged": head + 4 * start4 + i,
            "staged_owner": (i % (run * threads)) // run,
            "rest": np.r_[head + 4 * (start4 + staged4) + j, ends],
            "rest_owner": np.r_[(j // 4) % threads,
                                np.zeros(ends.size, np.int64)]})
    return out


def list_owner(length: int, threads: int = THREADS) -> np.ndarray:
    """The thread of each entry of a block's list: contiguous runs of an
    odd count."""
    return np.arange(length) // (-(-length // threads) | 1)


def run_histogram(bins: np.ndarray, owner: np.ndarray, size: int
                  ) -> tuple[np.ndarray, int]:
    """A block's histogram as its threads add it, values in the order
    each thread takes them (``owner`` grouped by thread): a thread counts
    a run of equal bins and adds (bin, count) where the bin changes and at
    its end. Returns the histogram and the number of such shared-memory
    atomics."""
    hist = np.zeros(size, np.int64)
    if bins.size == 0:
        return hist, 0
    starts = np.r_[True, (owner[1:] != owner[:-1]) | (bins[1:] != bins[:-1])]
    at = np.nonzero(starts)[0]
    np.add.at(hist, bins[at], np.diff(np.r_[at, bins.size]))
    return hist, int(at.size)


def _by_thread(idx: np.ndarray, owner: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    order = np.argsort(owner, kind="stable")
    return idx[order], owner[order]


def cooperative_select(values: np.ndarray, k: float, *, blocks: int,
                       cap4: int, head: int = 0, threads: int = THREADS,
                       run: int = RUN, iters: int = ITERS) -> dict:
    """``k10_select`` written out in numpy: the blocks' slices
    (``block_slices``); pass 0, each block's run histogram over its
    staged values and the rest; where v is selected, each block's list of
    its staged values not below the pass-0 bucket's least value (in
    order) and passes 1 and 2 over the list and the rest; the merged bins
    and every block's own pick; the replay; the sum over the list, or
    over the staged values where no list was made, or over the slice in
    device memory where a value left out of the list may lie above lo.
    Returns ``lo``, the top-k sum (f64 per block, added in block order,
    rounded once; the order within a block is not kept), each pass's
    picks by block, its atomics, the lists' lengths and the sum's
    source."""
    keys = order_keys(values)
    vals = np.asarray(values, np.float32).ravel()
    n = keys.size
    kk = target_rank(k, n)
    select = 1 <= kk <= n
    plan = block_slices(n, head, blocks, cap4, threads, run)
    seen = np.concatenate([np.r_[p["staged"], p["rest"]] for p in plan])
    assert np.array_equal(np.sort(seen), np.arange(n))
    sweeps = [_by_thread(np.r_[p["staged"], p["rest"]],
                         np.r_[p["staged_owner"], p["rest_owner"]])
              for p in plan]
    prefix, rank, picks, atomics, lists, kmin0 = 0, kk, [], [], None, 0
    for pass_, (shift, bits) in enumerate(DIGITS):
        if pass_ and not select:
            break
        if pass_ == 1:
            kmin0 = prefix << 21
            va = key_value(kmin0)
            lists = [p["staged"][~(vals[p["staged"]] < va)] for p in plan]
            sweeps = [_by_thread(np.r_[lst, p["rest"]],
                                 np.r_[list_owner(lst.size, threads),
                                       p["rest_owner"]])
                      for lst, p in zip(lists, plan)]
        merged, flushes = np.zeros(1 << bits, np.int64), 0
        for idx, owner in sweeps:
            kb = keys[idx]
            take = (np.ones(kb.size, bool) if pass_ == 0
                    else (kb >> np.uint32(shift + bits)) == prefix)
            hist, f = run_histogram(
                ((kb[take] >> np.uint32(shift)) & ((1 << bits) - 1)
                 ).astype(np.int64), owner[take], 1 << bits)
            merged += hist
            flushes += f
        atomics.append(flushes)
        if select:
            picks.append([pick_bucket(merged, rank) for _ in plan])
            digit, rank = picks[-1][0]
            prefix = (prefix << bits) | digit if pass_ else digit
    v = key_value(prefix) if select else None
    lo = replay(key_value(int(keys.max())), v, kk, n, iters)
    below = key_value((kmin0 - 1) & 0xFFFFFFFF)
    if np.isnan(below):
        below = np.float32(np.inf if kmin0 - 1 >= 0x80000000 else -np.inf)
    if not select:
        source, parts = "staged", [np.r_[p["staged"], p["rest"]]
                                   for p in plan]
    elif kmin0 == 0 or not lo < below:
        source, parts = "list", [np.r_[lst, p["rest"]]
                                 for lst, p in zip(lists, plan)]
    else:
        source, parts = "device memory", [np.r_[p["staged"], p["rest"]]
                                          for p in plan]
    total, count = 0.0, 0
    for idx in parts:
        above = vals[idx] > lo
        total += float(vals[idx][above].astype(np.float64).sum())
        count += int(above.sum())
    out = np.float32(total + float(lo) * (float(np.float32(k)) - count))
    return {"lo": lo, "out": out, "picks": picks, "atomics": atomics,
            "lists": None if lists is None else [x.size for x in lists],
            "source": source}

# ---------------------------------------------------------- kernels ----

def _blocks(device: torch.device) -> int:
    """Four blocks of 512 threads an SM: the gradient's grid."""
    return 4 * torch.cuda.get_device_properties(device).multi_processor_count


def topk_select(values: torch.Tensor, k: torch.Tensor, iters: int = ITERS,
                state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k sum and the bisection's lo, both 0-d f32, of a contiguous
    f32 map on the card, by one cooperative launch of ``k10_select``.
    ``state`` is the launch's scratch, ``ohem_state_bytes()`` of uint8 on
    the map's device with any contents (the kernel zeroes what it needs);
    a new one by ``torch.empty`` when not given."""
    on_cuda(values, k)
    n = values.numel()
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"the select takes 1 to 2**31 - 1 values, got {n}")
    lib = load_library()
    if state is None:
        state = torch.empty(lib.ohem_state_bytes(), dtype=torch.uint8,
                            device=values.device)
    elif (state.device != values.device or state.dtype != torch.uint8
          or state.numel() < lib.ohem_state_bytes()
          or not state.is_contiguous()):
        raise ValueError("the scratch must be ohem_state_bytes() contiguous "
                         "uint8 on the map's device")
    out = torch.empty((), dtype=torch.float32, device=values.device)
    lo = torch.empty_like(out)
    with torch.cuda.device(values.device):
        err = lib.ohem_topk_sum(values.data_ptr(), n, k.data_ptr(),
                                state.data_ptr(), iters, out.data_ptr(),
                                lo.data_ptr(), stream_of(values))
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
