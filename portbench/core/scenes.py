"""Frozen scene generator and ground-truth maps of the benchmark's traffic.

The scene generator is a copy of the port's hard-scene generator
(``data/synthetic._render_hard_sample`` and its helpers, with cv2 as the text
engine): up to 8 rotated, small and curved words over a graded, noisy
background with unlabeled clutter. It is copied, not imported, so that a
change to the program cannot move the benchmark's inputs.

``gt_maps`` gives the four DB training maps of a scene with the semantics of
the port's ``data/labels.make_gt_maps`` (shrink ratio 0.4, offset
d = A(1 - r²)/L, words under 8 px or tagged ``###`` masked out, threshold map
0.3 + 0.4 · (1 - distance/d) over the dilated word), computed from distance
fields on pixel centres instead of the port's polygon-offset library.
"""

from __future__ import annotations

import numpy as np

_UPPER = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
IGNORE_TAG = "###"


def rng_for(seed: int, *stream: int) -> np.random.RandomState:
    """A numpy generator for one stream of ``seed`` (any non-negative
    integer, also past 32 bits)."""
    state = np.random.SeedSequence([int(seed), *stream]).generate_state(1)
    return np.random.RandomState(int(state[0]))


# ----------------------------------------------------------- generator ----

def _text_size(text, font, scale, thickness):
    import cv2

    return cv2.getTextSize(text, font, scale, thickness)


def _draw(shape, text, org, font, scale, color, thickness):
    import cv2

    patch = np.zeros(tuple(shape) + (3,), np.uint8)
    mask = np.zeros(tuple(shape), np.uint8)
    cv2.putText(patch, text, org, font, scale, color, thickness)
    cv2.putText(mask, text, org, font, scale, 255, thickness)
    return patch, mask


def _paste_patch(img, patch, mask, x, y):
    h, w = patch.shape[:2]
    H, W = img.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    if x1 <= x0 or y1 <= y0:
        return False
    ps = patch[y0 - y:y1 - y, x0 - x:x1 - x]
    ms = mask[y0 - y:y1 - y, x0 - x:x1 - x][..., None].astype(np.float32)
    region = img[y0:y1, x0:x1].astype(np.float32)
    img[y0:y1, x0:x1] = (region * (1 - ms)
                         + ps.astype(np.float32) * ms).astype(np.uint8)
    return True


def _glyph_patch(rng, text, font_scale, color, thickness=None):
    import cv2

    thickness = thickness or max(1, 1 + int(font_scale))
    font = int(rng.choice([cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_DUPLEX,
                           cv2.FONT_HERSHEY_COMPLEX_SMALL]))
    (tw, th), baseline = _text_size(text, font, font_scale, thickness)
    m = 3
    patch, mask = _draw((th + baseline + 2 * m, tw + 2 * m), text,
                        (m, m + th), font, font_scale, color, thickness)
    return patch, (mask > 0).astype(np.uint8)


def _bbox_overlaps(b, occupied, margin=6):
    return any(not (b[2] < o[0] - margin or b[0] > o[2] + margin
                    or b[3] < o[1] - margin or b[1] > o[3] + margin)
               for o in occupied)


def _rotated_word(rng, img, occupied, size, small=False):
    import cv2

    text = "".join(rng.choice(list(_UPPER))
                   for _ in range(rng.randint(3, 9)))
    font_scale = rng.uniform(0.45, 0.8) if small else rng.uniform(0.9, 2.0)
    dark = rng.rand() < 0.7
    color = tuple(int(v) for v in (rng.randint(0, 50, 3) if dark
                                   else rng.randint(200, 255, 3)))
    patch, mask = _glyph_patch(rng, text, font_scale, color)
    angle = rng.uniform(-50, 50)
    ph, pw = patch.shape[:2]
    rot = cv2.getRotationMatrix2D((pw / 2, ph / 2), angle, 1.0)
    cos, sin = abs(rot[0, 0]), abs(rot[0, 1])
    nw, nh = int(pw * cos + ph * sin) + 2, int(pw * sin + ph * cos) + 2
    rot[0, 2] += nw / 2 - pw / 2
    rot[1, 2] += nh / 2 - ph / 2
    rpatch = cv2.warpAffine(patch, rot, (nw, nh))
    rmask = cv2.warpAffine(mask, rot, (nw, nh))
    if nw >= size - 4 or nh >= size - 4:
        return None
    x = rng.randint(2, size - nw - 2)
    y = rng.randint(2, size - nh - 2)
    corners = np.array([[0, 0], [pw, 0], [pw, ph], [0, ph]], np.float64)
    poly = corners @ rot[:, :2].T + rot[:, 2] + np.array([x, y])
    bbox = (poly[:, 0].min(), poly[:, 1].min(),
            poly[:, 0].max(), poly[:, 1].max())
    if _bbox_overlaps(bbox, occupied):
        return None
    _paste_patch(img, rpatch, rmask, x, y)
    occupied.append(bbox)
    return np.clip(poly, 0, size - 1), text


def _curved_word(rng, img, occupied, size):
    import cv2

    text = "".join(rng.choice(list(_UPPER))
                   for _ in range(rng.randint(5, 10)))
    font_scale = rng.uniform(0.8, 1.4)
    thickness = 1 + int(font_scale)
    dark = rng.rand() < 0.7
    color = tuple(int(v) for v in (rng.randint(0, 50, 3) if dark
                                   else rng.randint(200, 255, 3)))
    (tw, th), _ = _text_size(text, cv2.FONT_HERSHEY_SIMPLEX, font_scale,
                             thickness)
    length = int(tw * 1.15)
    amp = rng.uniform(0.25, 0.9) * th * 2 * rng.choice([-1, 1])
    if length >= size - 40:
        return None
    x0 = rng.randint(10, size - length - 10)
    y0 = rng.randint(int(th * 2 + abs(amp)) + 10,
                     size - int(th + abs(amp)) - 10)

    def base(t):
        return (x0 + t * length, y0 + amp * np.sin(t * np.pi))

    bxs = np.array([base(t) for t in np.linspace(0, 1, 64)])
    bbox = (bxs[:, 0].min() - 4, bxs[:, 1].min() - th - 4,
            bxs[:, 0].max() + 4, bxs[:, 1].max() + 6)
    if _bbox_overlaps(bbox, occupied):
        return None
    n = len(text)
    for i, ch in enumerate(text):
        t = (i + 0.5) / n
        cx, cy = base(t)
        dy = amp * np.pi * np.cos(t * np.pi) / length
        ang = -np.degrees(np.arctan2(dy, 1.0))
        patch, mask = _glyph_patch(rng, ch, font_scale, color, thickness)
        ph, pw = patch.shape[:2]
        rot = cv2.getRotationMatrix2D((pw / 2, ph / 2), ang, 1.0)
        rpatch = cv2.warpAffine(patch, rot, (pw, ph))
        rmask = cv2.warpAffine(mask, rot, (pw, ph))
        _paste_patch(img, rpatch, rmask, int(cx - pw / 2),
                     int(cy - ph / 2 - th * 0.2))
    ts = np.linspace(0, 1, 7)
    pts = np.array([base(t) for t in ts])
    top = pts + np.array([0.0, -th * 0.9])
    bottom = (pts + np.array([0.0, th * 0.55]))[::-1]
    occupied.append(bbox)
    poly = np.concatenate([top, bottom], axis=0)
    return np.clip(poly, 0, size - 1), text


def _distractors(rng, img, occupied, size):
    import cv2

    for _ in range(rng.randint(2, 6)):
        kind = rng.randint(4)
        w = rng.randint(30, 120)
        h = rng.randint(10, 60)
        if size - w - 4 <= 4 or size - h - 4 <= 4:
            continue
        x = rng.randint(2, size - w - 2)
        y = rng.randint(2, size - h - 2)
        bbox = (x, y, x + w, y + h)
        if _bbox_overlaps(bbox, occupied):
            continue
        occupied.append(bbox)
        shade = int(rng.randint(0, 60)) if rng.rand() < 0.5 \
            else int(rng.randint(190, 255))
        color = (shade, shade, shade)
        if kind == 0:
            n = max(w // 6, 3)
            for i in range(n):
                sx = x + i * w // n
                cv2.rectangle(img, (sx, y), (sx + rng.randint(1, 3), y + h),
                              color, -1)
        elif kind == 1:
            for gy in range(y, y + h, max(h // 4, 3)):
                cv2.line(img, (x, gy), (x + w, gy), color, 1)
            for gx in range(x, x + w, max(w // 6, 3)):
                cv2.line(img, (gx, y), (gx, y + h), color, 1)
        elif kind == 2:
            pts = np.stack([rng.randint(x, x + w, 6),
                            rng.randint(y, y + h, 6)], axis=1)
            cv2.polylines(img, [pts.astype(np.int32)], False, color, 2)
        else:
            if rng.rand() < 0.5:
                cv2.rectangle(img, (x, y), (x + w, y + h), color, -1)
            else:
                cv2.circle(img, (x + w // 2, y + h // 2), min(w, h) // 2,
                           color, -1)


def _hard_background(rng, size):
    import cv2

    base = rng.randint(90, 200, size=3).astype(np.float32)
    grad_dir = rng.rand() < 0.5
    ramp = np.linspace(-40, 40, size, dtype=np.float32)
    ramp2d = ramp[:, None] if grad_dir else ramp[None, :]
    img = np.clip(base[None, None, :]
                  + np.broadcast_to(ramp2d, (size, size))[..., None],
                  0, 255).astype(np.uint8)
    noise = rng.randint(0, 25, size=(size, size, 3), dtype=np.uint8)
    return cv2.add(img, noise)


def hard_scene(rng, size=640, max_words=8):
    """One scene: (uint8 (size, size, 3) image, [(poly, text)]), a text of
    ``###`` marking an ignored word."""
    img = _hard_background(rng, size)
    occupied: list = []
    words = []
    n_words = rng.randint(3, max_words + 1)
    tries = 0
    while len(words) < n_words and tries < 80:
        tries += 1
        r = rng.rand()
        if r < 0.3:
            res = _curved_word(rng, img, occupied, size)
        elif r < 0.55:
            res = _rotated_word(rng, img, occupied, size, small=True)
        else:
            res = _rotated_word(rng, img, occupied, size, small=False)
        if res is None:
            continue
        poly, text = res
        ignore = rng.rand() < 0.12
        words.append((poly, IGNORE_TAG if ignore else text))
    _distractors(rng, img, occupied, size)
    return img, words


# ------------------------------------------------------------ GT maps ----

def _area_perimeter(poly: np.ndarray) -> tuple[float, float]:
    x, y = poly[:, 0], poly[:, 1]
    area = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    perimeter = float(np.linalg.norm(poly - np.roll(poly, -1, 0),
                                     axis=1).sum())
    return float(area), perimeter


def _boundary_distance(poly: np.ndarray, xs: np.ndarray,
                       ys: np.ndarray) -> np.ndarray:
    """Distance of each point (xs, ys) to the closed polygon's edges."""
    best = np.full(xs.shape, np.inf)
    for (ax, ay), (bx, by) in zip(poly, np.roll(poly, -1, 0)):
        ex, ey = bx - ax, by - ay
        px, py = xs - ax, ys - ay
        t = np.clip((px * ex + py * ey) / max(ex * ex + ey * ey, 1e-24),
                    0, 1)
        px -= t * ex
        py -= t * ey
        np.minimum(best, px * px + py * py, out=best)
    return np.sqrt(best)


def _inside(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    import cv2

    m = np.zeros((h, w), np.uint8)
    cv2.fillPoly(m, [np.round(poly).astype(np.int32)], 1)
    return m.astype(bool)


def gt_maps(words, size: int, min_text_size: int = 8,
            shrink_ratio: float = 0.4, thresh_min: float = 0.3,
            thresh_max: float = 0.7):
    """(prob_map, supervision_mask, thresh_map, text_area_map), each a
    float32 (size, size) map, of a scene's words."""
    import cv2

    gt = np.zeros((size, size), np.float32)
    mask = np.ones((size, size), np.float32)
    canvas = np.zeros((size, size), np.float32)
    area_mask = np.zeros((size, size), np.float32)
    for poly, text in words:
        poly = np.asarray(poly, np.float64)
        area, length = _area_perimeter(poly)
        extent = poly.max(0) - poly.min(0)
        if area < 1 or extent.min() < min_text_size or text == IGNORE_TAG:
            cv2.fillPoly(mask, [np.round(poly).astype(np.int32)], 0.0)
            continue
        d = area * (1 - shrink_ratio ** 2) / length
        x0, y0 = np.floor(poly.min(0) - d - 1).astype(int)
        x1, y1 = np.ceil(poly.max(0) + d + 1).astype(int)
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, size - 1), min(y1, size - 1)
        ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
        dist = _boundary_distance(poly, xs, ys)
        inside = _inside(poly, size, size)[y0:y1 + 1, x0:x1 + 1]
        shrunk = inside & (dist >= d)
        if not shrunk.any():
            cv2.fillPoly(mask, [np.round(poly).astype(np.int32)], 0.0)
            continue
        gt[y0:y1 + 1, x0:x1 + 1][shrunk] = 1.0
        area_mask[y0:y1 + 1, x0:x1 + 1][inside | (dist <= d)] = 1.0
        win = canvas[y0:y1 + 1, x0:x1 + 1]
        np.maximum(win, np.clip(1 - dist / d, 0, 1).astype(np.float32),
                   out=win)
    thresh = canvas * (thresh_max - thresh_min) + thresh_min
    return gt, mask, thresh.astype(np.float32), area_mask


def resize_pad(img: np.ndarray, size: int = 640) -> np.ndarray:
    """The port's ``utils.test_resize(img, size, pad=True)``: the longer
    side to ``size`` at the image's aspect, then zero padding at the right
    and the bottom to a square canvas."""
    import cv2

    h, w, c = img.shape
    scale = min(size / w, size / h)
    h, w = int(h * scale), int(w * scale)
    resized = img if (h, w) == img.shape[:2] else cv2.resize(img, (w, h))
    out = np.zeros((size, size, c), img.dtype)
    out[:h, :w] = resized
    return out
