"""Python bindings for the host geometry library (``cpp/geometry.cpp``).

The port's own copy of ``db_text_minimal_tpu/ops/geometry``, bound for what
the rect- and polygon-mode postprocess, the training labels and the IoU and
DetEval metrics need: polygon area, perimeter and simplicity, the
Clipper-style round-join offset (shrink, dilate, unclip), ``min_area_rect``,
``approx_poly_dp`` (Douglas-Peucker), ``find_contours``,
``fill_poly``, the border distance field of the threshold map, and polygon
intersection and union areas. The shared library is compiled with g++ at
first use into the port's build directory.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .._native import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp",
                    "geometry.cpp")
_LOCK = threading.Lock()
_lib = None


def load_library() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(build_library(_SRC, "libgeometry", "cxx"))
            c_dp = ctypes.POINTER(ctypes.c_double)
            c_ip = ctypes.POINTER(ctypes.c_int)
            c_fp = ctypes.POINTER(ctypes.c_float)
            c_u8p = ctypes.POINTER(ctypes.c_uint8)
            for name in ("geo_polygon_area", "geo_polygon_signed_area",
                         "geo_polygon_perimeter"):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_double
                fn.argtypes = [c_dp, ctypes.c_int]
            lib.geo_min_area_rect.restype = None
            lib.geo_min_area_rect.argtypes = [c_dp, ctypes.c_int, c_dp, c_dp]
            lib.geo_approx_poly_dp.restype = ctypes.c_int
            lib.geo_approx_poly_dp.argtypes = [c_dp, ctypes.c_int,
                                               ctypes.c_double, c_dp,
                                               ctypes.c_int]
            lib.geo_offset_polygon.restype = ctypes.c_int
            lib.geo_offset_polygon.argtypes = [
                c_dp, ctypes.c_int, ctypes.c_double, ctypes.c_double, c_dp,
                c_ip, ctypes.c_int, ctypes.c_int]
            lib.geo_find_contours.restype = ctypes.c_int
            lib.geo_find_contours.argtypes = [c_u8p, ctypes.c_int,
                                              ctypes.c_int, c_ip, c_ip,
                                              ctypes.c_int, ctypes.c_int]
            lib.geo_fill_poly.restype = None
            lib.geo_fill_poly.argtypes = [c_fp, ctypes.c_int, ctypes.c_int,
                                          c_dp, ctypes.c_int, ctypes.c_float]
            lib.geo_polygon_is_simple.restype = ctypes.c_int
            lib.geo_polygon_is_simple.argtypes = [c_dp, ctypes.c_int]
            lib.geo_intersection_area.restype = ctypes.c_double
            lib.geo_intersection_area.argtypes = [c_dp, ctypes.c_int, c_dp,
                                                  ctypes.c_int]
            lib.geo_border_distance_field.restype = None
            lib.geo_border_distance_field.argtypes = [
                c_dp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, c_fp]
            _lib = lib
    return _lib


def _as_poly(poly) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(poly, dtype=np.float64).reshape(-1, 2))


def _dp(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def polygon_area(poly) -> float:
    p = _as_poly(poly)
    return float(load_library().geo_polygon_area(_dp(p), len(p)))


def polygon_signed_area(poly) -> float:
    p = _as_poly(poly)
    return float(load_library().geo_polygon_signed_area(_dp(p), len(p)))


def polygon_perimeter(poly) -> float:
    p = _as_poly(poly)
    return float(load_library().geo_polygon_perimeter(_dp(p), len(p)))


def polygon_is_simple(poly) -> bool:
    """At least 3 vertices and no self-intersection."""
    p = _as_poly(poly)
    if len(p) < 3:
        return False
    return bool(load_library().geo_polygon_is_simple(_dp(p), len(p)))


def intersection_area(poly_a, poly_b) -> float:
    """Area of the intersection of two simple polygons."""
    a, b = _as_poly(poly_a), _as_poly(poly_b)
    if len(a) < 3 or len(b) < 3:
        return 0.0
    return float(load_library().geo_intersection_area(_dp(a), len(a),
                                                      _dp(b), len(b)))


def union_area(poly_a, poly_b) -> float:
    """Area of the union of two simple polygons (inclusion-exclusion)."""
    return (polygon_area(poly_a) + polygon_area(poly_b)
            - intersection_area(poly_a, poly_b))


def min_area_rect(points):
    """cv2.minAreaRect equivalent: (4 corners float64 (4, 2), (w, h))."""
    p = _as_poly(points)
    corners = np.empty((4, 2), dtype=np.float64)
    wh = np.empty((2,), dtype=np.float64)
    load_library().geo_min_area_rect(_dp(p), len(p), _dp(corners), _dp(wh))
    return corners, (float(wh[0]), float(wh[1]))


def approx_poly_dp(poly, epsilon: float) -> np.ndarray:
    """cv2.approxPolyDP equivalent for a closed curve (Douglas-Peucker):
    (M, 2) float64 vertices of ``poly`` within ``epsilon`` of it."""
    p = _as_poly(poly)
    out = np.empty((max(len(p), 4), 2), dtype=np.float64)
    m = load_library().geo_approx_poly_dp(_dp(p), len(p), float(epsilon),
                                          _dp(out), len(out))
    return out[:m]


def offset_polygon(poly, delta: float, arc_tolerance: float = 0.25,
                   integer: bool = True) -> list[np.ndarray]:
    """Clipper-style closed-polygon offset with round joins (pyclipper
    ``JT_ROUND``/``ET_CLOSEDPOLYGON``); ``integer=True`` rounds inputs and
    outputs to the integer grid as pyclipper does. Largest loop first."""
    p = _as_poly(poly)
    if integer:
        p = np.round(p)
    max_pts = 16 * len(p) + 4096
    out_xy = np.empty((max_pts, 2), dtype=np.float64)
    out_sizes = np.zeros((64,), dtype=np.int32)
    n_polys = load_library().geo_offset_polygon(
        _dp(p), len(p), float(delta), float(arc_tolerance), _dp(out_xy),
        out_sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_pts, 64)
    result = []
    start = 0
    for i in range(n_polys):
        size = int(out_sizes[i])
        loop = out_xy[start:start + size].copy()
        start += size
        if delta < 0:
            # a genuine shrink keeps every vertex at least |delta| from the
            # input boundary; loop-split artifacts of collapsed regions
            # sit closer (pyclipper returns [] for over-shrunk polygons)
            if _min_distance_to_boundary(loop, p) < abs(delta) - 1.5:
                continue
        if integer:
            loop = np.round(loop)
            keep = np.any(loop != np.roll(loop, 1, axis=0), axis=1)
            loop = loop[keep]
            if len(loop) < 3:
                continue
            loop = loop.astype(np.int64)
        result.append(loop)
    result.sort(key=lambda q: -abs(polygon_signed_area(q)))
    # drop slivers whose centroid lies inside an already-kept larger loop,
    # as Clipper's nonzero-fill union would absorb them
    kept: list[np.ndarray] = []
    for loop in result:
        centroid = np.asarray(loop, dtype=np.float64).mean(axis=0)
        if any(_point_in_polygon(centroid, k) for k in kept):
            continue
        kept.append(loop)
    return kept


def _min_distance_to_boundary(points: np.ndarray, poly: np.ndarray) -> float:
    pts = np.asarray(points, dtype=np.float64)
    a = np.asarray(poly, dtype=np.float64)
    ab = np.roll(a, -1, axis=0) - a
    ap = pts[:, None, :] - a[None, :, :]
    denom = np.maximum((ab * ab).sum(-1), 1e-12)
    t = np.clip((ap * ab[None]).sum(-1) / denom, 0.0, 1.0)
    closest = a[None] + t[..., None] * ab[None]
    return float(np.linalg.norm(pts[:, None, :] - closest,
                                axis=-1).min(axis=1).min())


def _point_in_polygon(point, poly) -> bool:
    """Ray-casting even-odd test (boundary counts as inside)."""
    x, y = float(point[0]), float(point[1])
    p = np.asarray(poly, dtype=np.float64)
    x0, y0 = p[:, 0], p[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    crosses = (y0 <= y) != (y1 <= y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x0 + (y - y0) / (y1 - y0) * (x1 - x0)
    return bool(np.count_nonzero(crosses & (x < xint)) % 2)


def find_contours(binary_image: np.ndarray, max_contours: int = 2048):
    """cv2.findContours(RETR_LIST, CHAIN_APPROX_SIMPLE) equivalent
    (Suzuki-Abe border following): list of (K, 2) int32 (x, y) arrays."""
    img = np.ascontiguousarray(binary_image.astype(np.uint8))
    h, w = img.shape
    max_pts = h * w + 4
    out_pts = np.empty((max_pts, 2), dtype=np.int32)
    out_sizes = np.zeros((max_contours,), dtype=np.int32)
    n = load_library().geo_find_contours(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_pts,
        max_contours)
    contours = []
    start = 0
    for i in range(n):
        size = int(out_sizes[i])
        contours.append(out_pts[start:start + size].copy())
        start += size
    return contours


def fill_poly(image: np.ndarray, polys, value: float = 1.0) -> np.ndarray:
    """cv2.fillPoly equivalent, in place on a C-contiguous float32 image."""
    if image.dtype != np.float32 or not image.flags.c_contiguous:
        raise ValueError("fill_poly needs a C-contiguous float32 image")
    h, w = image.shape
    if isinstance(polys, np.ndarray) and polys.ndim == 2:
        polys = [polys]
    lib = load_library()
    for poly in polys:
        p = _as_poly(poly)
        lib.geo_fill_poly(
            image.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
            _dp(p), len(p), float(value))
    return image


def border_distance_field(poly, height: int, width: int,
                          norm: float) -> np.ndarray:
    """(height, width) f32 map: each pixel's distance to the nearest edge of
    ``poly``, divided by ``norm`` and clipped to [0, 1] (the threshold map's
    distance field)."""
    p = _as_poly(poly)
    out = np.empty((height, width), dtype=np.float32)
    load_library().geo_border_distance_field(
        _dp(p), len(p), height, width, float(norm),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
