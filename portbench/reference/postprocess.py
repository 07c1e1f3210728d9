"""Plain rect-mode box extraction of DBNet (arXiv:1911.08947 §3.5, the
reference repository's ``boxes_from_bitmap``), in numpy and scipy, with no
code of the measured program, in the semantics the configuration states:

- pixels above ``thresh`` form 8-connected components, numbered in the
  raster order of their first pixel; the first ``max_candidates`` are
  candidates;
- a candidate's score is its mean probability over its pixels and its
  holes: 4-connected background components that touch no image border,
  each given to the lowest-numbered candidate among its pixels'
  8-neighbours (only the first ``max_candidates`` background components
  count);
- the candidate's minimum-area rectangle around its pixel centres (exact,
  by rotating calipers over the convex hull); kept when its shorter side is
  at least ``min_size`` and its score at least ``box_thresh``;
- unclip: grown by d = A · ``unclip_ratio`` / L on every side (the
  round-join offset's minimum-area rectangle), kept when the shorter side
  is then at least ``min_size`` + 2; corners in clockwise order from the
  top left, rounded to whole pixels and clipped to the map.
"""

from __future__ import annotations

import numpy as np

# the angles at which ``Candidate.boxes_near_least`` puts a rectangle
ANGLE_STEP_DEG = 0.1
_EIGHT = np.ones((3, 3), bool)
_FOUR = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def _hull(points: np.ndarray) -> np.ndarray:
    pts = sorted(set(map(tuple, points.tolist())))
    if len(pts) < 3:
        return np.asarray(pts, np.float64)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1], np.float64)


def rect_at(hull: np.ndarray, u: np.ndarray):
    """(area, centre (2,), u, (w along u, h)) of the rectangle around the
    points ``hull`` (M, 2) with a side along the unit vector ``u``."""
    v = np.array([-u[1], u[0]])
    pu, pv = hull @ u, hull @ v
    u0, u1, v0, v1 = pu.min(), pu.max(), pv.min(), pv.max()
    centre = u * (u0 + u1) / 2 + v * (v0 + v1) / 2
    return (u1 - u0) * (v1 - v0), centre, u, (u1 - u0, v1 - v0)


def min_area_rect(points: np.ndarray):
    """(area, centre (2,), unit axis u (2,), (w along u, h)) of the
    minimum-area rectangle around ``points`` (M, 2), by rotating calipers:
    the least of the rectangles with a side along a hull edge."""
    hull = _hull(points)
    if len(hull) == 1:
        return 0.0, hull[0], np.array([1.0, 0.0]), (0.0, 0.0)
    best = None
    for i in range(len(hull)):
        e = hull[(i + 1) % len(hull)] - hull[i]
        length = np.hypot(*e)
        if length < 1e-12:
            continue
        r = rect_at(hull, e / length)
        if best is None or r[0] < best[0]:
            best = r
    return best


def _corners(centre, u, w, h) -> np.ndarray:
    v = np.array([-u[1], u[0]])
    return np.array([centre + su * w / 2 * u + sv * h / 2 * v
                     for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1))])


def order_corners(pts: np.ndarray) -> np.ndarray:
    """Clockwise from the top left: the two leftmost points by x, the upper
    of them first; then the upper of the two rightmost."""
    p = sorted(pts.tolist(), key=lambda q: q[0])
    i1, i4 = (0, 1) if p[1][1] > p[0][1] else (1, 0)
    i2, i3 = (2, 3) if p[3][1] > p[2][1] else (3, 2)
    return np.array([p[i1], p[i2], p[i3], p[i4]])


def candidate_scores(prob: np.ndarray, thresh: float, k: int):
    """(labels, number of candidates, score per candidate) of one map."""
    from scipy import ndimage

    h, w = prob.shape
    mask = prob > thresh
    fg, n_fg = ndimage.label(mask, structure=_EIGHT)
    n = min(n_fg, k)
    slot = np.where((fg > 0) & (fg <= k), fg - 1, k)
    bg, n_bg = ndimage.label(~mask, structure=_FOUR)
    m = min(n_bg, k)
    border = np.zeros(n_bg + 1, bool)
    for edge in (bg[0], bg[-1], bg[:, 0], bg[:, -1]):
        border[edge] = True
    near = ndimage.minimum_filter(slot, size=3, mode="constant", cval=k)
    enclosing = np.full(n_bg + 1, k)
    if m:
        enclosing[1:m + 1] = ndimage.minimum(near, bg, np.arange(1, m + 1))
    target = np.where((enclosing < k) & ~border, enclosing, k)
    target[0] = k
    target[m + 1:] = k
    flat_slot = slot.reshape(-1)
    flat_prob = prob.reshape(-1).astype(np.float64)
    cnt = np.bincount(flat_slot, minlength=k + 1)[:k].astype(np.float64)
    psum = np.bincount(flat_slot, flat_prob, minlength=k + 1)[:k]
    hole_of = target[bg.reshape(-1)]
    hcnt = np.bincount(hole_of, minlength=k + 1)[:k].astype(np.float64)
    hsum = np.bincount(hole_of, flat_prob, minlength=k + 1)[:k]
    denom = cnt + hcnt
    scores = np.where(denom > 0, (psum + hsum) / np.maximum(denom, 1), 0.0)
    return fg, n, scores[:n]


def _finish(rect, pp: dict, w: int, h: int):
    """The box of one pre-unclip rectangle, or None where a size filter
    drops it."""
    _, centre, u, (rw, rh) = rect
    if min(rw, rh) < pp["min_size"]:
        return None
    d = rw * rh * pp["unclip_ratio"] / (2 * (rw + rh))
    rw, rh = rw + 2 * d, rh + 2 * d
    if min(rw, rh) < pp["min_size"] + 2:
        return None
    quad = order_corners(_corners(centre, u, rw, rh))
    quad[:, 0] = np.clip(np.round(quad[:, 0]), 0, w)
    quad[:, 1] = np.clip(np.round(quad[:, 1]), 0, h)
    return quad.astype(np.int64)


class Candidate:
    """A kept candidate's hull and least rectangle area, from which
    ``match`` works out its boxes at other orientations."""

    def __init__(self, hull: np.ndarray, area: float, pp: dict,
                 shape: tuple):
        self.hull, self.area, self.pp, self.shape = hull, area, pp, shape
        self._grid = None

    def boxes_near_least(self, tie: float):
        """(boxes (K, 4, 2), excess (K,)): the candidate's box along every
        ``ANGLE_STEP_DEG`` of a quarter turn whose rectangle's area exceeds
        the least by at most the share ``tie`` and passes the size filters;
        corners clockwise, rounded and clipped to the map."""
        if self._grid is not None and self._grid[0] == tie:
            return self._grid[1:]
        pp, (h, w) = self.pp, self.shape
        theta = np.deg2rad(np.arange(0.0, 90.0, ANGLE_STEP_DEG))
        u = np.stack([np.cos(theta), np.sin(theta)], 1)
        v = np.stack([-u[:, 1], u[:, 0]], 1)
        pu, pv = self.hull @ u.T, self.hull @ v.T
        u0, u1, v0, v1 = pu.min(0), pu.max(0), pv.min(0), pv.max(0)
        rw, rh = u1 - u0, v1 - v0
        excess = rw * rh / max(self.area, 1e-12) - 1.0
        d = rw * rh * pp["unclip_ratio"] / (2 * np.maximum(rw + rh, 1e-12))
        big_w, big_h = rw + 2 * d, rh + 2 * d
        keep = ((excess <= tie) & (np.minimum(rw, rh) >= pp["min_size"])
                & (np.minimum(big_w, big_h) >= pp["min_size"] + 2))
        centre = (u * ((u0 + u1) / 2)[:, None] + v * ((v0 + v1) / 2)[:, None])
        quads = np.stack([centre + (su * big_w / 2)[:, None] * u
                          + (sv * big_h / 2)[:, None] * v
                          for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1))],
                         1)[keep]
        quads[..., 0] = np.clip(np.round(quads[..., 0]), 0, w)
        quads[..., 1] = np.clip(np.round(quads[..., 1]), 0, h)
        self._grid = (tie, quads, excess[keep])
        return self._grid[1:]


def boxes(prob: np.ndarray, pp: dict):
    """(boxes (M, 4, 2) int64, scores (M,) float64, candidates (M,
    ``Candidate``)) of one prob map."""
    from scipy import ndimage

    k = pp["max_candidates"]
    fg, n, scores = candidate_scores(prob, pp["thresh"], k)
    h, w = prob.shape
    out_boxes, out_scores, cands = [], [], []
    wanted = np.nonzero(scores >= pp["box_thresh"])[0]
    spans = ndimage.find_objects(fg, max_label=n) if len(wanted) else []
    for i in wanted:
        sl = spans[i]
        ys, xs = np.nonzero(fg[sl] == i + 1)
        pts = np.stack([xs + sl[1].start, ys + sl[0].start], 1)
        rect = min_area_rect(pts)
        quad = _finish(rect, pp, w, h)
        if quad is None:
            continue
        out_boxes.append(quad)
        out_scores.append(scores[i])
        cands.append(Candidate(_hull(pts), rect[0], pp, (h, w)))
    if not out_boxes:
        return np.zeros((0, 4, 2), np.int64), np.zeros(0), []
    return np.stack(out_boxes), np.asarray(out_scores), cands


def _corner_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(len(a), len(b)) largest corner gap in pixels of each pair of
    quads, at the best cyclic shift of the corners."""
    a = np.asarray(a, np.float64)[:, None]
    b = np.asarray(b, np.float64)[None]
    return np.min([np.abs(a - np.roll(b, s, axis=2)).max(axis=(2, 3))
                   for s in range(4)], axis=0)


def match(a_boxes, b_boxes, tol: float, b_cands=None, tie: float = 0.0):
    """One-to-one matching of two box sets of one image, nearest first: a
    pair's distance is the largest corner gap in pixels, at the best
    cyclic shift of the corners; pairs within ``tol`` match. With
    ``b_cands`` (``boxes``' candidates), an ``a`` box may also match the
    ``b`` candidate's box at another orientation, where that rectangle's
    area exceeds the least by at most the share ``tie`` (a search for the
    least rectangle that steps its angle, or ends near a tie). Returns the
    matched pairs as (i, j, that excess)."""
    na, nb = len(a_boxes), len(b_boxes)
    if na == 0 or nb == 0:
        return []
    dist = _corner_gap(a_boxes, b_boxes)
    excess = np.zeros((na, nb))
    if b_cands is not None:
        # a box whose corners lie further from b's than b's own extent is
        # of another component
        extent = np.ptp(np.asarray(b_boxes, np.float64), axis=1).max(axis=1)
        for i in range(na):
            for j, cand in enumerate(b_cands):
                if dist[i, j] <= tol or dist[i, j] > extent[j] + tol:
                    continue
                quads, share = cand.boxes_near_least(tie)
                if not len(quads):
                    continue
                g = _corner_gap(a_boxes[i:i + 1], quads)[0]
                k = int(g.argmin())
                if g[k] < dist[i, j]:
                    dist[i, j], excess[i, j] = g[k], share[k]
    order = np.dstack(np.unravel_index(np.argsort(dist, axis=None,
                                                  kind="stable"),
                                       dist.shape))[0]
    used_a, used_b, pairs = set(), set(), []
    for i, j in order:
        if dist[i, j] > tol:
            break
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        pairs.append((int(i), int(j), float(excess[i, j])))
    return pairs
