"""Device postprocess: connected components and per-component statistics.

Port of ``db_text_minimal_tpu/ops/pallas/cc.py``. Kernels written by hand
in CUDA for Hopper (``csrc/cc.cu``) carry it:

- K3 ``connected_components`` (cc.py:63-111): union-find labelling, label =
  linear index of the component's minimum pixel, background -1.
- K4 ``compact_slots`` (cc.py:114-144): slot of each pixel = raster rank of
  its component's root, overflow and background in slot K.
- K5 ``rotated_boxes`` (cc.py:181-320 with ``_rect_corners``): per-slot
  moments, PCA angle, a 4-stage angle search, extents, corners, scores.
- K6 ``hole_stats`` (cc.py:383-444): prob sum and count of the background
  holes that each foreground component encloses, routed over the
  4-connected background's K3 labels and K4 slots.
- K7 and K8 ``bbox_stats`` (cc.py:147-178 and :463-473): per-slot pixel
  count, prob sum and integer bbox; K7 ``pack_bits`` (cc.py:482-491): the
  binary map bit-packed MSB-first, rows padded to whole bytes.

``device_boxes`` (cc.py:323-380) composes them over a batch for rect mode,
so only (N, K) records leave the device; ``device_poly_stats``
(cc.py:447-503) for polygon mode, so the packed map and (N, K) records
leave it; ``component_boxes`` and ``fast_boxes`` (cc.py:147-178, :506-521)
give axis-aligned boxes. Scores are always hole-filled in rect mode (the
JAX default) and the angle search always uses ``NUM_ANGLES`` candidates per
fine stage.

Every wrapper takes batched tensors. On a CUDA tensor it launches its
kernel, counts the launch in ``LAUNCHES`` and raises if the kernel does not
build or launch; on a CPU tensor it runs the plain PyTorch version beside it
(the CPU tests hold those against the JAX functions). The plain versions
repeat the kernels' arithmetic: exact integer coordinate sums and f64 prob
and moment sums, where the JAX version sums in f32 by scatter.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from ._native import CSRC, build_library, check_launch, on_cuda, stream_of

LAUNCHES = {"connected_components_8": 0, "connected_components_4": 0,
            "compact_slots": 0, "hole_stats": 0, "rotated_boxes": 0,
            "bbox_stats": 0, "pack_bits": 0}

NUM_ANGLES = 5

_BIG = 1e9
_LIB = None
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_library() -> ctypes.CDLL:
    """Build ``csrc/cc.cu`` (first call only) and bind its C entries."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library(os.path.join(CSRC, "cc.cu"),
                                            "libcc", "cuda"))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.cc_label.argtypes = [p, p, i, i, i, i, p]
            lib.cc_compact.argtypes = [p, p, p, p, p, i, i, i, p]
            lib.cc_hole_route.argtypes = [p, p, p, p, p, p, p, p,
                                          i, i, i, i, p]
            lib.cc_rot_boxes.argtypes = ([p] * 6 + [p, i] + [p] * 17
                                         + [i, i, i, i, p])
            lib.cc_bbox_stats.argtypes = [p, p, p, p, p, i, i, i, i, p]
            lib.cc_pack_bits.argtypes = [p, p, i, i, i, p]
            for fn in (lib.cc_label, lib.cc_compact, lib.cc_hole_route,
                       lib.cc_rot_boxes, lib.cc_bbox_stats, lib.cc_pack_bits):
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def _as_mask(mask: torch.Tensor) -> torch.Tensor:
    if mask.dim() != 3:
        raise ValueError(f"mask must be (N, H, W), got {tuple(mask.shape)}")
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    if mask.dtype != torch.uint8:
        raise TypeError(f"mask must be bool or uint8, got {mask.dtype}")
    return mask.contiguous()


def _neighbour_min(x: torch.Tensor, fill: int,
                   connectivity: int) -> torch.Tensor:
    """Min over the 8 (or 4) neighbours of each pixel of (N, H, W) ``x``,
    self excluded; outside the image counts as ``fill``."""
    n, h, w = x.shape
    padded = x.new_full((n, h + 2, w + 2), fill)
    padded[:, 1:-1, 1:-1] = x
    best = x.new_full(x.shape, fill)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy == 0 and dx == 0) or (connectivity == 4 and dy and dx):
                continue
            best = torch.minimum(
                best, padded[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return best


# ------------------------------------------------------------------ K3 ----

def connected_components_plain(mask: torch.Tensor,
                               connectivity: int = 8) -> torch.Tensor:
    """Plain version of K3: parent pointers with min-hooking of roots and
    pointer jumping (the FastSV scheme), run to its fixed point (no round
    cap). Every value is a pixel index of the same component and only
    decreases, so the fixed point is each component's minimum index."""
    n, h, w = mask.shape
    hw = h * w
    fg = mask.bool().reshape(n, hw)
    sentinel = torch.full((n, 1), hw, dtype=torch.int64, device=mask.device)
    f = torch.where(fg, torch.arange(hw, device=mask.device), hw)
    while True:
        prev = f
        mn = _neighbour_min(f.view(n, h, w), hw, connectivity).reshape(n, hw)
        mn = torch.minimum(f, torch.where(fg, mn, hw))
        table = torch.cat([f, sentinel], 1)
        table.scatter_reduce_(1, f, mn, "amin")    # hook: f[f[u]] <= mn[u]
        f = torch.minimum(table[:, :hw], mn)
        f = torch.cat([f, sentinel], 1).gather(1, f)   # jump: f <- f[f]
        if torch.equal(f, prev):
            break
    return torch.where(fg, f, -1).to(torch.int32).view(n, h, w)


def connected_components(mask: torch.Tensor,
                         connectivity: int = 8) -> torch.Tensor:
    """K3: (N, H, W) bool/uint8 mask -> (N, H, W) int32 labels. A label is
    the linear index (within its image) of its component's minimum pixel;
    background is -1. ``connectivity`` is 8 or 4; each has its own launch
    count (``connected_components_8`` / ``_4``)."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    mask = _as_mask(mask)
    if not on_cuda(mask):
        return connected_components_plain(mask, connectivity)
    n, h, w = mask.shape
    labels = torch.empty((n, h, w), dtype=torch.int32, device=mask.device)
    with torch.cuda.device(mask.device):
        err = load_library().cc_label(mask.data_ptr(), labels.data_ptr(),
                                      n, h, w, connectivity, stream_of(mask))
    check_launch(err, "connected_components")
    LAUNCHES[f"connected_components_{connectivity}"] += 1
    return labels


# ------------------------------------------------------------------ K4 ----

def compact_slots_plain(labels: torch.Tensor, max_components: int):
    """Plain version of K4: slot = min(rank of the label's root, K)."""
    n = labels.shape[0]
    flat = labels.reshape(n, -1).long()
    hw = flat.shape[1]
    is_root = flat == torch.arange(hw, device=labels.device)
    rank = torch.cumsum(is_root, 1) - 1
    root_rank = rank.gather(1, flat.clamp(min=0))
    keyed = torch.where(flat >= 0, root_rank.clamp(max=max_components),
                        max_components).to(torch.int32)
    valid_root = (torch.arange(max_components, device=labels.device)[None]
                  < is_root.sum(1, keepdim=True))
    return keyed, valid_root


def compact_slots(labels: torch.Tensor, max_components: int):
    """K4: labels (N, H, W) or (N, H·W) int32 -> (keyed (N, H·W) int32 slot
    per pixel, valid_root (N, K) bool). Slots follow the raster order of
    each component's root; overflow components and background get slot K."""
    n = labels.shape[0]
    labels = labels.reshape(n, -1)
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32, got {labels.dtype}")
    if not on_cuda(labels):
        return compact_slots_plain(labels, max_components)
    labels = labels.contiguous()
    hw = labels.shape[1]
    dev = labels.device
    keyed = torch.empty((n, hw), dtype=torch.int32, device=dev)
    valid_root = torch.empty((n, max_components), dtype=torch.uint8,
                             device=dev)
    chunk = torch.empty((n, -(-hw // 1024)), dtype=torch.int32, device=dev)
    rank_at = torch.empty((n, hw), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = load_library().cc_compact(
            labels.data_ptr(), keyed.data_ptr(), valid_root.data_ptr(),
            chunk.data_ptr(), rank_at.data_ptr(), n, hw, max_components,
            stream_of(labels))
    check_launch(err, "compact_slots")
    LAUNCHES["compact_slots"] += 1
    return keyed, valid_root.bool()


# ------------------------------------------------------------------ K6 ----

def hole_stats_plain(mask, fg_keyed, bg_keyed, prob, max_components):
    """Plain version of K6."""
    n, h, w = mask.shape
    k = max_components
    bg_key = bg_keyed.long()
    bg = ~mask.bool().reshape(n, -1)
    rows = torch.arange(h, device=mask.device)[:, None]
    cols = torch.arange(w, device=mask.device)[None, :]
    is_border = ((rows == 0) | (rows == h - 1) | (cols == 0)
                 | (cols == w - 1)).reshape(1, -1).expand(n, -1)
    border_hits = torch.zeros((n, k + 1), dtype=torch.int64,
                              device=mask.device)
    border_hits.scatter_reduce_(1, bg_key, is_border.long(), "amax")
    neigh_best = _neighbour_min(fg_keyed.reshape(n, h, w).long(), k, 8)
    enclosing = torch.full((n, k + 1), k, dtype=torch.int64,
                           device=mask.device)
    enclosing.scatter_reduce_(
        1, bg_key, torch.where(bg, neigh_best.reshape(n, -1), k), "amin")
    target = torch.where((enclosing < k) & (border_hits == 0), enclosing, k)
    per_pixel = torch.where(bg, target.gather(1, bg_key), k)
    hole_sum = torch.zeros((n, k + 1), dtype=torch.float64,
                           device=mask.device)
    hole_sum.scatter_add_(1, per_pixel, prob.reshape(n, -1).double())
    hole_cnt = torch.zeros((n, k + 1), dtype=torch.int64, device=mask.device)
    hole_cnt.scatter_add_(1, per_pixel, torch.ones_like(per_pixel))
    return hole_sum[:, :k].float(), hole_cnt[:, :k].float()


def hole_stats(mask: torch.Tensor, fg_keyed: torch.Tensor,
               bg_keyed: torch.Tensor, prob: torch.Tensor,
               max_components: int):
    """K6: per foreground slot, the prob sum and pixel count of the
    background holes it encloses -> ((N, K) f32, (N, K) f32).

    ``bg_keyed`` holds the K4 slots of the 4-connected background
    components (complement connectivity of the 8-connected foreground).
    Holes are those that touch no image border; each goes to the MIN
    foreground slot among its pixels' 8-neighbours, the enclosing component
    even when another one is nested inside the hole."""
    mask = _as_mask(mask)
    n, h, w = mask.shape
    fg_keyed = fg_keyed.reshape(n, h * w)
    bg_keyed = bg_keyed.reshape(n, h * w)
    prob = prob.reshape(n, h, w)
    if (fg_keyed.dtype != torch.int32 or bg_keyed.dtype != torch.int32
            or prob.dtype != torch.float32):
        raise TypeError("fg_keyed and bg_keyed must be int32, prob float32")
    if not on_cuda(mask, fg_keyed, bg_keyed, prob):
        return hole_stats_plain(mask, fg_keyed, bg_keyed, prob,
                                max_components)
    k = max_components
    dev = mask.device
    fg_keyed, bg_keyed = fg_keyed.contiguous(), bg_keyed.contiguous()
    prob = prob.contiguous()
    border = torch.zeros((n, k + 1), dtype=torch.int32, device=dev)
    enclosing = torch.full((n, k + 1), k, dtype=torch.int32, device=dev)
    hole_sum = torch.zeros((n, k), dtype=torch.float64, device=dev)
    hole_cnt = torch.zeros((n, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = load_library().cc_hole_route(
            mask.data_ptr(), fg_keyed.data_ptr(), bg_keyed.data_ptr(),
            prob.data_ptr(), border.data_ptr(), enclosing.data_ptr(),
            hole_sum.data_ptr(), hole_cnt.data_ptr(), n, h, w, k,
            stream_of(mask))
    check_launch(err, "hole_stats")
    LAUNCHES["hole_stats"] += 1
    return hole_sum.float(), hole_cnt.float()


# ------------------------------------------------------------------ K5 ----

def _jnp_linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace`` in float32 as XLA compiles it for the JAX version:
    start·(1 − i·r) + i·(stop·r) with r = 1/(num − 1) rounded to f32, then
    the exact stop."""
    f32 = np.float32
    r = f32(1) / f32(num - 1)
    i = np.arange(num - 1, dtype=f32)
    head = f32(start) * (f32(1) - i * r) + i * f32(f32(stop) * r)
    return np.concatenate([head, [f32(stop)]]).astype(f32)


def stage_offsets() -> list[np.ndarray]:
    """Candidate angle offsets (radians, f32) of the four search stages:
    ±45° with 2·na+3 candidates, then three stages of na = ``NUM_ANGLES``,
    each bracketing the previous spacing (cc.py:256-281)."""
    na = NUM_ANGLES
    shrink = (na - 1) // 2 + 1
    span2 = 45.0 / (na + 1)
    span3 = span2 / shrink
    deg = np.float32(np.pi / 180.0)
    return [_jnp_linspace_f32(-s, s, c) * deg
            for s, c in ((45.0, 2 * na + 3), (span2, na), (span3, na),
                         (span3 / shrink, na))]


def _seg(values: torch.Tensor, key: torch.Tensor, k: int, reduce: str,
         init: float = 0.0) -> torch.Tensor:
    """Segment reduction of (..., P) values into (..., k) slots by key;
    slot ``k`` collects the dropped pixels."""
    out = values.new_full(values.shape[:-1] + (k + 1,), init)
    if reduce == "sum":
        out.scatter_add_(-1, key.expand_as(values), values)
    else:
        out.scatter_reduce_(-1, key.expand_as(values), values, reduce)
    return out[..., :k]


def _lookup(table: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Per-pixel value of its slot; the dropped slot reads 0."""
    padded = torch.cat([table, table.new_zeros(table.shape[:-1] + (1,))], -1)
    return padded.gather(-1, key.expand(table.shape[:-1] + key.shape[-1:]))


def _rect_corners(cx, cy, c, s, half_w, half_h):
    us = torch.stack([-half_w, half_w, half_w, -half_w], -1)
    vs = torch.stack([-half_h, -half_h, half_h, half_h], -1)
    px = cx[..., None] + us * c[..., None] - vs * s[..., None]
    py = cy[..., None] + us * s[..., None] + vs * c[..., None]
    return torch.stack([px, py], -1)


def rotated_boxes_plain(prob, keyed, valid_root, hole_sum, hole_cnt,
                        max_components):
    """Plain version of K5, with the kernel's order of f32 operations."""
    n, h, w = prob.shape
    k = max_components
    dev = prob.device
    key = keyed.long()
    flat_prob = prob.reshape(n, -1)
    pix = torch.arange(h * w, device=dev)
    xs_i, ys_i = (pix % w).expand(n, -1), (pix // w).expand(n, -1)
    count = _seg(torch.ones_like(key), key, k, "sum")
    psum = _seg(flat_prob.double(), key, k, "sum")
    safe = count.clamp(min=1).double()
    cx = (_seg(xs_i, key, k, "sum").double() / safe).float()
    cy = (_seg(ys_i, key, k, "sum").double() / safe).float()
    fg = key < k
    dx = xs_i.float() - _lookup(cx, key)
    dy = ys_i.float() - _lookup(cy, key)
    zero = torch.zeros((), device=dev)
    sxx = _seg(torch.where(fg, dx * dx, zero).double(), key, k, "sum")
    syy = _seg(torch.where(fg, dy * dy, zero).double(), key, k, "sum")
    sxy = _seg(torch.where(fg, dx * dy, zero).double(), key, k, "sum")
    theta = 0.5 * torch.atan2(2.0 * sxy.float(), sxx.float() - syy.float())

    key3 = key[:, None, :]
    for offsets in stage_offsets():
        off = torch.from_numpy(offsets).to(dev)
        ang = theta[:, None, :] + off[None, :, None]              # (N, A, K)
        c, s = _lookup(torch.cos(ang), key3), _lookup(torch.sin(ang), key3)
        u = dx[:, None] * c + dy[:, None] * s
        v = -dx[:, None] * s + dy[:, None] * c
        fg3 = fg[:, None, :]
        exts = torch.stack([
            _seg(torch.where(fg3, u, _BIG), key3, k, "amin", _BIG),
            _seg(torch.where(fg3, u, -_BIG), key3, k, "amax", -_BIG),
            _seg(torch.where(fg3, v, _BIG), key3, k, "amin", _BIG),
            _seg(torch.where(fg3, v, -_BIG), key3, k, "amax", -_BIG)], -1)
        areas = ((exts[..., 1] - exts[..., 0])
                 * (exts[..., 3] - exts[..., 2]))                 # (N, A, K)
        best = torch.argmin(areas, dim=1)                         # first min
        theta = theta + off[best]
        ext = exts.gather(1, best[:, None, :, None].expand(-1, 1, -1, 4))[:, 0]
    umin, umax, vmin, vmax = ext.unbind(-1)
    c, s = torch.cos(theta), torch.sin(theta)
    uc, vc = (umin + umax) / 2.0, (vmin + vmax) / 2.0
    ctr_x = cx + uc * c - vc * s
    ctr_y = cy + uc * s + vc * c
    corners = _rect_corners(ctr_x, ctr_y, c, s, (umax - umin) / 2.0,
                            (vmax - vmin) / 2.0)
    sides = torch.stack([umax - umin, vmax - vmin], -1)
    n_f = count.float()
    valid = valid_root & (n_f > 0)
    denom = n_f + hole_cnt
    scores = torch.where(valid & (denom > 0),
                         (psum.float() + hole_sum) / denom.clamp(min=1.0), 0.0)
    return corners, sides, scores, valid


def rotated_boxes(prob: torch.Tensor, keyed: torch.Tensor,
                  valid_root: torch.Tensor, hole_sum: torch.Tensor,
                  hole_cnt: torch.Tensor, max_components: int):
    """K5: per-slot oriented min-rects of the components in ``keyed``.

    Returns corners (N, K, 4, 2) f32 xy, sides (N, K, 2) = (w, h), scores
    (N, K) mean prob over each component and its holes (``hole_sum`` and
    ``hole_cnt`` from ``hole_stats``) and valid (N, K) bool."""
    n, h, w = prob.shape
    k = max_components
    keyed = keyed.reshape(n, h * w)
    if prob.dtype != torch.float32 or keyed.dtype != torch.int32:
        raise TypeError("prob must be float32 and keyed int32")
    if hole_sum.dtype != torch.float32 or hole_cnt.dtype != torch.float32:
        raise TypeError("hole sums and counts must be float32")
    if not on_cuda(prob, keyed, valid_root, hole_sum, hole_cnt):
        return rotated_boxes_plain(prob, keyed, valid_root, hole_sum,
                                   hole_cnt, k)
    stages = stage_offsets()
    sizes = [len(o) for o in stages]
    dev = prob.device
    prob, keyed = prob.contiguous(), keyed.contiguous()
    valid_root = valid_root.contiguous().view(torch.uint8)
    offsets = torch.from_numpy(np.concatenate(stages)).to(dev)
    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    max_a = max(sizes)

    def zeros(dtype, *shape):
        return torch.zeros((n, k) + shape, dtype=dtype, device=dev)

    def empty(dtype, *shape):
        return torch.empty((n, k) + shape, dtype=dtype, device=dev)

    cnt = zeros(i32)
    psum, sxx, syy, sxy = (zeros(f64) for _ in range(4))
    sx, sy = zeros(torch.int64), zeros(torch.int64)
    cx, cy, theta = empty(f32), empty(f32), empty(f32)
    cs, ext, best_ext = empty(f32, max_a, 2), empty(i32, max_a, 4), \
        empty(f32, 4)
    corners, sides, scores = empty(f32, 4, 2), empty(f32, 2), empty(f32)
    valid = empty(torch.uint8)
    hole_sum, hole_cnt = hole_sum.contiguous(), hole_cnt.contiguous()
    size_arr = (ctypes.c_int * len(sizes))(*sizes)
    with torch.cuda.device(dev):
        err = load_library().cc_rot_boxes(
            prob.data_ptr(), keyed.data_ptr(), valid_root.data_ptr(),
            hole_sum.data_ptr(), hole_cnt.data_ptr(), offsets.data_ptr(),
            ctypes.cast(size_arr, ctypes.c_void_p), len(sizes),
            *(t.data_ptr() for t in (
                cnt, psum, sx, sy, sxx, syy, sxy, cx, cy, theta, cs, ext,
                best_ext, corners, sides, scores, valid)),
            n, h, w, k, stream_of(prob))
    check_launch(err, "rotated_boxes")
    LAUNCHES["rotated_boxes"] += 1
    return corners, sides, scores, valid.bool()


# ------------------------------------------------------------- K7, K8 ----

def bbox_stats_plain(keyed: torch.Tensor, prob: torch.Tensor,
                     max_components: int):
    """Plain version of the K7/K8 stats pass: exact counts and integer
    extremes, f64 prob sums."""
    n, h, w = prob.shape
    k = max_components
    key = keyed.reshape(n, -1).long()
    pix = torch.arange(h * w, device=prob.device)
    xs, ys = (pix % w).expand(n, -1), (pix // w).expand(n, -1)
    count = _seg(torch.ones_like(key), key, k, "sum")
    psum = _seg(prob.reshape(n, -1).double(), key, k, "sum")
    bbox = torch.stack([_seg(xs, key, k, "amin", w),
                        _seg(ys, key, k, "amin", h),
                        _seg(xs, key, k, "amax", -1),
                        _seg(ys, key, k, "amax", -1)], -1)
    return count.to(torch.int32), psum, bbox.to(torch.int32)


def bbox_stats(keyed: torch.Tensor, prob: torch.Tensor,
               max_components: int):
    """K7/K8 stats: per slot of ``keyed`` (N, H·W) int32 over ``prob``
    (N, H, W) f32, the pixel count (N, K) int32, the prob sum (N, K) f64 and
    the bbox (N, K, 4) int32 as [xmin, ymin, xmax, ymax]. An empty slot
    keeps count 0, sum 0 and bbox [W, H, -1, -1], the JAX fill values."""
    n, h, w = prob.shape
    k = max_components
    keyed = keyed.reshape(n, h * w)
    if prob.dtype != torch.float32 or keyed.dtype != torch.int32:
        raise TypeError("prob must be float32 and keyed int32")
    if not on_cuda(keyed, prob):
        return bbox_stats_plain(keyed, prob, k)
    dev = prob.device
    keyed, prob = keyed.contiguous(), prob.contiguous()
    cnt = torch.empty((n, k), dtype=torch.int32, device=dev)
    psum = torch.empty((n, k), dtype=torch.float64, device=dev)
    bbox = torch.empty((n, k, 4), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = load_library().cc_bbox_stats(
            keyed.data_ptr(), prob.data_ptr(), cnt.data_ptr(),
            psum.data_ptr(), bbox.data_ptr(), n, h, w, k, stream_of(prob))
    check_launch(err, "bbox_stats")
    LAUNCHES["bbox_stats"] += 1
    return cnt, psum, bbox


def pack_bits_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the K7 bit-pack."""
    n, h, w = mask.shape
    w8 = -(-w // 8)
    bits = torch.zeros((n, h, w8 * 8), dtype=torch.int32, device=mask.device)
    bits[..., :w] = (mask != 0).int()
    weights = 1 << torch.arange(7, -1, -1, device=mask.device)
    return (bits.view(n, h, w8, 8) * weights).sum(-1).to(torch.uint8)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """K7 bit-pack: (N, H, W) bool/uint8 mask -> (N, H, ⌈W/8⌉) uint8, the
    first pixel of each byte in its most significant bit (the order
    ``np.unpackbits`` reads); the last byte of a row is padded with 0."""
    mask = _as_mask(mask)
    if not on_cuda(mask):
        return pack_bits_plain(mask)
    n, h, w = mask.shape
    packed = torch.empty((n, h, -(-w // 8)), dtype=torch.uint8,
                         device=mask.device)
    with torch.cuda.device(mask.device):
        err = load_library().cc_pack_bits(mask.data_ptr(), packed.data_ptr(),
                                          n, h, w, stream_of(mask))
    check_launch(err, "pack_bits")
    LAUNCHES["pack_bits"] += 1
    return packed


# ------------------------------------------------------------ composition --

def _as_prob_maps(prob_maps: torch.Tensor) -> torch.Tensor:
    if prob_maps.dim() != 3:
        raise ValueError(f"prob_maps must be (N, H, W), got "
                         f"{tuple(prob_maps.shape)}")
    return prob_maps.float().contiguous()


def component_rotated_boxes(prob: torch.Tensor, labels: torch.Tensor,
                            max_components: int = 100):
    """cc.py:181-310 with hole-filled scores over a batch: labels (N, H, W)
    from ``connected_components`` -> K4; K3 (4-connected) and K4 on the
    background -> K6; then K5. Returns corners, sides, scores, valid."""
    k = max_components
    keyed, valid_root = compact_slots(labels, k)
    mask = labels >= 0
    bg_keyed, _ = compact_slots(connected_components(~mask, 4), k)
    hole_sum, hole_cnt = hole_stats(mask, keyed, bg_keyed, prob, k)
    return rotated_boxes(prob, keyed, valid_root, hole_sum, hole_cnt, k)


def device_boxes(prob_maps: torch.Tensor, thresh: float = 0.3,
                 box_thresh: float = 0.7, min_size: int = 3,
                 max_components: int = 1000):
    """Rotated-box postprocess over a batch of prob maps (N, H, W) on their
    device: threshold -> K3 -> K4 -> K3/K4 on the background -> K6 -> K5 ->
    min_size and box_thresh filters. Returns (corners (N, K, 4, 2), scores
    (N, K), keep (N, K)); the rects are pre-unclip, for the exact host
    finishing in ``postprocess.finish_device_rects``."""
    prob = _as_prob_maps(prob_maps)
    labels = connected_components(prob > thresh)
    corners, sides, scores, valid = component_rotated_boxes(
        prob, labels, max_components=max_components)
    keep = (valid & (torch.minimum(sides[..., 0], sides[..., 1]) >= min_size)
            & (scores >= box_thresh))
    return corners, scores, keep


def device_poly_stats(prob_maps: torch.Tensor, thresh: float = 0.3,
                      max_components: int = 1000):
    """Device half of the polygon postprocess over a batch (N, H, W):
    threshold -> K3 -> K4 -> per-slot count, prob sum and bbox -> K3/K4 on
    the background -> K6 -> hole-filled scores, and the bit-packed bitmap.
    Returns (packed (N, H, ⌈W/8⌉) uint8, bboxes (N, K, 4) int32 [xmin,
    ymin, xmax, ymax], scores (N, K) f32, valid (N, K) bool). A slot's score
    is its mean prob over the component and its holes wherever it has
    pixels or holes, as in the JAX version, whether or not it is valid."""
    prob = _as_prob_maps(prob_maps)
    k = max_components
    mask = prob > thresh
    keyed, valid_root = compact_slots(connected_components(mask), k)
    cnt, psum, bboxes = bbox_stats(keyed, prob, k)
    bg_keyed, _ = compact_slots(connected_components(~mask, 4), k)
    hole_sum, hole_cnt = hole_stats(mask, keyed, bg_keyed, prob, k)
    denom = cnt.float() + hole_cnt
    scores = torch.where(denom > 0, (psum.float() + hole_sum)
                         / denom.clamp(min=1.0), 0.0)
    return pack_bits(mask), bboxes, scores, valid_root & (cnt > 0)


def component_boxes(prob: torch.Tensor, labels: torch.Tensor,
                    max_components: int = 100):
    """K8 over a batch: labels (N, H, W) from ``connected_components`` ->
    K4 -> boxes (N, K, 4) f32 [xmin, ymin, xmax, ymax], scores (N, K) mean
    prob over each component (0 where not valid), areas (N, K) f32 pixel
    counts and valid (N, K) bool."""
    keyed, valid_root = compact_slots(labels, max_components)
    cnt, psum, bbox = bbox_stats(keyed, prob, max_components)
    areas = cnt.float()
    valid = valid_root & (cnt > 0)
    scores = torch.where(valid, psum.float() / areas.clamp(min=1.0), 0.0)
    return bbox.float(), scores, areas, valid


def fast_boxes(prob_maps: torch.Tensor, thresh: float = 0.3,
               box_thresh: float = 0.7, min_size: int = 3,
               max_components: int = 1000):
    """Axis-aligned boxes over a batch (N, H, W): threshold -> K3 -> K8 ->
    keep where valid, score >= box_thresh and the smaller side (in pixels,
    ends included) >= min_size. Returns (boxes, scores, keep)."""
    prob = _as_prob_maps(prob_maps)
    labels = connected_components(prob > thresh)
    boxes, scores, _, valid = component_boxes(prob, labels, max_components)
    wide = boxes[..., 2] - boxes[..., 0] + 1
    tall = boxes[..., 3] - boxes[..., 1] + 1
    keep = (valid & (scores >= box_thresh)
            & (torch.minimum(wide, tall) >= min_size))
    return boxes, scores, keep
