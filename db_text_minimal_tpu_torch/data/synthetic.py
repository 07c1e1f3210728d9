"""Synthetic scene-text datasets in the TotalText and CTW1500 GT formats.

Port of ``db_text_minimal_tpu/data/synthetic.py`` (numpy and cv2; the
glyphs are cv2's Hershey fonts, so no font file is needed): ``generate``
(boxes of strokes on noise, optionally curved 14-point words),
``generate_hard`` (the hard benchmark: rotated, curved, small and
ignore-tagged words over text-like clutter) and ``generate_hard_ctw`` (its
line-level CTW1500 form). Every draw from the ``RandomState`` happens in the
JAX module's order and every label is written with ``{v:.1f}``, so a seed
gives the same images and GT files as the JAX package. The glyphs are
measured and drawn through a text engine object (``data.text_engine``),
cv2's own unless a recorded one is given. For the recognizer:
``generate_glyphs`` (words of real glyph strings with their transcriptions)
and ``export_word_crops`` (the GT words of a dataset's train split, warped
to 32x100 by the geometry library, with ``labels.txt``).
"""

from __future__ import annotations

import os

import numpy as np

from .text_engine import CV2TextEngine

CV2_TEXT = CV2TextEngine()


def _curved_word_poly(rng, size, w, h):
    """CTW1500-style curved text polygon: 7 points along a bent baseline,
    7 back along the top (14 points total, matching the CTW parse shape)."""
    x = rng.randint(0, max(size - w - 1, 1))
    y = rng.randint(h + 10, max(size - h - 10, h + 11))
    bend = rng.uniform(-0.4, 0.4) * h * 3
    ts = np.linspace(0, 1, 7)
    base_x = x + ts * w
    base_y = y + bend * np.sin(ts * np.pi)
    top = np.stack([base_x, base_y - h], axis=1)
    bottom = np.stack([base_x[::-1], base_y[::-1]], axis=1)
    return np.concatenate([top, bottom], axis=0)


def _render_sample(rng: np.random.RandomState, size: int = 640,
                   max_words: int = 6, curved_prob: float = 0.0):
    import cv2

    img = np.full((size, size, 3), 0, np.uint8)
    # textured background
    img[:] = rng.randint(120, 200, size=(1, 1, 3), dtype=np.uint8)
    noise = rng.randint(0, 30, size=(size, size, 3), dtype=np.uint8)
    img = cv2.add(img, noise)

    polys = []
    n_words = rng.randint(1, max_words + 1)
    tries = 0
    while len(polys) < n_words and tries < 50:
        tries += 1
        w = rng.randint(max(size // 8, 24), max(size // 3, 48))
        h = rng.randint(max(size // 26, 12), max(size // 11, 24))
        if rng.rand() < curved_prob:
            box = np.clip(_curved_word_poly(rng, size, w, h), 2, size - 3)
        else:
            x = rng.randint(0, size - w - 1)
            y = rng.randint(0, size - h - 1)
            box = np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]],
                           np.float64)
            angle = rng.uniform(-8, 8)
            center = box.mean(axis=0)
            rad = np.deg2rad(angle)
            rot = np.array([[np.cos(rad), -np.sin(rad)],
                            [np.sin(rad), np.cos(rad)]])
            box = np.clip((box - center) @ rot.T + center, 2, size - 3)
        # reject overlap with existing words (keeps labels unambiguous)
        if any(not (box[:, 0].max() < p[:, 0].min() - 8
                    or box[:, 0].min() > p[:, 0].max() + 8
                    or box[:, 1].max() < p[:, 1].min() - 8
                    or box[:, 1].min() > p[:, 1].max() + 8) for p in polys):
            continue
        # dark "text" region with light glyph-like strokes
        cv2.fillPoly(img, [box.astype(np.int32)], (25, 25, 30))
        n = len(box)
        n_strokes = max(w // 18, 2)
        for s in range(n_strokes):
            t = (s + 0.5) / n_strokes
            if n == 4:
                p0 = box[0] * (1 - t) + box[1] * t
                p1 = box[3] * (1 - t) + box[2] * t
            else:  # curved: interpolate along top and bottom chains
                k = t * (n // 2 - 1)
                i = int(k)
                f = k - i
                p0 = box[i] * (1 - f) + box[i + 1] * f
                jtop = n - 1 - i
                p1 = box[jtop] * (1 - f) + box[jtop - 1] * f
            p0 = p0 * 0.85 + p1 * 0.15
            p1 = p1 * 0.85 + p0 * 0.15
            cv2.line(img, tuple(p0.astype(int)), tuple(p1.astype(int)),
                     (230, 230, 235), 2)
        polys.append(box)
    return img, polys


def _render_glyph_sample(rng: np.random.RandomState, size: int = 640,
                         max_words: int = 6, charset: str = "0123456789",
                         engine=CV2_TEXT):
    """Sample with real rendered text (Hershey glyphs, measured and drawn
    by the text engine ``engine``) so the recognizer can be trained end to
    end on synthetic data. Returns (image, [(poly, text), ...])."""
    import cv2

    img = np.full((size, size, 3),
                  rng.randint(140, 210, size=3, dtype=np.uint8), np.uint8)
    noise = rng.randint(0, 25, size=(size, size, 3), dtype=np.uint8)
    img = cv2.add(img, noise)
    words = []
    n_words = rng.randint(2, max_words + 1)
    tries = 0
    while len(words) < n_words and tries < 60:
        tries += 1
        text = "".join(rng.choice(list(charset))
                       for _ in range(rng.randint(3, 8)))
        font_scale = rng.uniform(1.2, 2.2)
        thickness = 2 + int(font_scale)
        (tw, th), baseline = engine.text_size(
            text, cv2.FONT_HERSHEY_SIMPLEX, font_scale, thickness)
        if tw + 20 >= size or th + 20 >= size:
            continue
        x = rng.randint(6, size - tw - 8)
        y = rng.randint(th + 8, size - baseline - 8)
        box = np.array([[x - 4, y - th - 4], [x + tw + 4, y - th - 4],
                        [x + tw + 4, y + baseline + 4],
                        [x - 4, y + baseline + 4]], np.float64)
        if any(not (box[:, 0].max() < p[:, 0].min() - 8
                    or box[:, 0].min() > p[:, 0].max() + 8
                    or box[:, 1].max() < p[:, 1].min() - 8
                    or box[:, 1].min() > p[:, 1].max() + 8)
               for p, _ in words):
            continue
        engine.put_text(img, text, (x, y), cv2.FONT_HERSHEY_SIMPLEX,
                        font_scale, (20, 20, 25), thickness)
        words.append((box, text))
    return img, words


def generate_glyphs(out_dir: str, n_train: int = 16, n_test: int = 4,
                    size: int = 640, seed: int = 0,
                    charset: str = "0123456789", text_engine=None) -> dict:
    """TotalText-format dataset whose words are real rendered glyph strings
    with true transcriptions in the label column: trains the detector and
    the recognizer end to end. The same seed gives the JAX package's images
    and GT under the same cv2."""
    rng = np.random.RandomState(seed)
    engine = text_engine or CV2_TEXT

    def sample():
        img, words = _render_glyph_sample(rng, size=size, charset=charset,
                                          engine=engine)
        lines = [f"{_coords(poly)},{text}" for poly, text in words]
        engine.end_image(img, lines)
        return img, lines

    dirs = _write_dataset(out_dir, n_train, n_test, 1000, sample,
                          "gt_img{}.txt")
    return {**dirs, "ignore_tags": ["###"]}


def export_word_crops(section: dict, out_dir: str, img_h: int = 32,
                      img_w: int = 100, jitter_copies: int = 4,
                      seed: int = 0) -> str:
    """Cut the GT word crops of ``section``'s train split, perspective-
    rectified to ``img_w`` x ``img_h`` by the geometry library, and write
    them with a ``labels.txt``: the training data of ``cli/train_rec``.
    Each word is exported ``jitter_copies`` times, all but the first with a
    random margin and corner jitter, so the recognizer learns the framing
    of the detector's unclipped boxes. A GT polygon of other than 4 points
    (a curved word) is rectified through its min-area rect, ordered
    clockwise from the top left, the transform ``cli/rec_bench._warp_crop``
    applies to detections. Ignore-tagged words are skipped."""
    import cv2

    from ..ops import geometry as geo
    from ..postprocess import order_rect_points
    from .parsers import load_totaltext

    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    fps, anns = load_totaltext(section["train_dir"],
                               section["train_gt_dir"])
    dst = np.array([[0, 0], [img_w, 0], [img_w, img_h], [0, img_h]],
                   np.float64)
    lines = []
    count = 0
    for fp, ann in zip(fps, anns):
        img = cv2.imread(fp)[:, :, ::-1]
        for item in ann:
            if item.get("text") == "###":
                continue
            poly = np.asarray(item["poly"], np.float64)
            if len(poly) != 4:
                try:
                    rect, _ = geo.min_area_rect(poly)
                except ValueError:
                    continue
                poly = np.asarray(order_rect_points(np.asarray(rect)),
                                  np.float64)
            center = poly.mean(axis=0)
            for copy in range(jitter_copies):
                if copy == 0:
                    box = poly
                else:
                    # random expansion (unclip-like) + corner jitter
                    grow = 1.0 + rng.uniform(0.0, 0.35)
                    box = (poly - center) * grow + center
                    box = box + rng.uniform(-3, 3, poly.shape)
                try:
                    matrix = geo.get_perspective_transform(box, dst)
                except ValueError:
                    continue
                warp = geo.warp_perspective(img, matrix, (img_w, img_h))
                fname = f"crop_{count}.jpg"
                cv2.imwrite(os.path.join(out_dir, fname), warp[:, :, ::-1])
                lines.append(f"{fname}\t{item['text']}")
                count += 1
    with open(os.path.join(out_dir, "labels.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return out_dir


_UPPER = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"


def _paste_patch(img, patch, mask, x, y):
    """Alpha-paste a rendered glyph patch into the scene at (x, y)."""
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


def _glyph_patch(rng, text, font_scale, color, thickness=None,
                 engine=CV2_TEXT):
    """Render ``text`` on a tight patch; returns (bgr patch, alpha mask)."""
    import cv2

    thickness = thickness or max(1, 1 + int(font_scale))
    font = int(rng.choice([cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_DUPLEX,
                           cv2.FONT_HERSHEY_COMPLEX_SMALL]))
    (tw, th), baseline = engine.text_size(text, font, font_scale, thickness)
    m = 3
    patch, mask = engine.draw((th + baseline + 2 * m, tw + 2 * m), text,
                              (m, m + th), font, font_scale, color,
                              thickness)
    return patch, (mask > 0).astype(np.uint8)


def _rotated_word(rng, img, occupied, size, small=False, engine=CV2_TEXT):
    """Paste a word rotated by up to ±50°; returns (poly, text) or None."""
    import cv2

    text = "".join(rng.choice(list(_UPPER))
                   for _ in range(rng.randint(3, 9)))
    font_scale = rng.uniform(0.45, 0.8) if small else rng.uniform(0.9, 2.0)
    dark = rng.rand() < 0.7
    color = tuple(int(v) for v in (rng.randint(0, 50, 3) if dark
                                   else rng.randint(200, 255, 3)))
    patch, mask = _glyph_patch(rng, text, font_scale, color,
                               engine=engine)
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


def _curved_word(rng, img, occupied, size, engine=CV2_TEXT):
    """Real glyphs along a bent baseline with per-char tangent rotation;
    GT is a CTW1500-style 14-point polygon (7 top + 7 bottom)."""
    import cv2

    text = "".join(rng.choice(list(_UPPER))
                   for _ in range(rng.randint(5, 10)))
    font_scale = rng.uniform(0.8, 1.4)
    thickness = 1 + int(font_scale)
    dark = rng.rand() < 0.7
    color = tuple(int(v) for v in (rng.randint(0, 50, 3) if dark
                                   else rng.randint(200, 255, 3)))
    (tw, th), _ = engine.text_size(text, cv2.FONT_HERSHEY_SIMPLEX,
                                   font_scale, thickness)
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
        # tangent angle of the baseline (image y points down)
        dy = amp * np.pi * np.cos(t * np.pi) / length
        ang = -np.degrees(np.arctan2(dy, 1.0))
        patch, mask = _glyph_patch(rng, ch, font_scale, color, thickness,
                                   engine)
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


def _bbox_overlaps(b, occupied, margin=6):
    return any(not (b[2] < o[0] - margin or b[0] > o[2] + margin
                    or b[3] < o[1] - margin or b[1] > o[3] + margin)
               for o in occupied)


def _distractors(rng, img, occupied, size):
    """Unlabeled text-LIKE clutter: barcode stripe groups, grids, polylines,
    solid shapes — the false-positive bait real scenes have."""
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
        if kind == 0:       # barcode stripes (very text-like locally)
            n = max(w // 6, 3)
            for i in range(n):
                sx = x + i * w // n
                cv2.rectangle(img, (sx, y), (sx + rng.randint(1, 3), y + h),
                              color, -1)
        elif kind == 1:     # grid
            for gy in range(y, y + h, max(h // 4, 3)):
                cv2.line(img, (x, gy), (x + w, gy), color, 1)
            for gx in range(x, x + w, max(w // 6, 3)):
                cv2.line(img, (gx, y), (gx, y + h), color, 1)
        elif kind == 2:     # random polyline scribble
            pts = np.stack([rng.randint(x, x + w, 6),
                            rng.randint(y, y + h, 6)], axis=1)
            cv2.polylines(img, [pts.astype(np.int32)], False, color, 2)
        else:               # solid shape
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
    img = cv2.add(img, noise)
    return img


def _render_hard_sample(rng, size=640, max_words=8, engine=CV2_TEXT):
    """One benchmark scene: rotated + curved + small + ignore-tagged words
    over distractor clutter, the glyphs from the text engine ``engine``.
    Returns (img, [(poly, text, ignore)])."""
    img = _hard_background(rng, size)
    occupied: list = []
    words = []
    n_words = rng.randint(3, max_words + 1)
    tries = 0
    while len(words) < n_words and tries < 80:
        tries += 1
        r = rng.rand()
        if r < 0.3:
            res = _curved_word(rng, img, occupied, size, engine)
        elif r < 0.55:
            res = _rotated_word(rng, img, occupied, size, small=True,
                                engine=engine)
        else:
            res = _rotated_word(rng, img, occupied, size, small=False,
                                engine=engine)
        if res is None:
            continue
        poly, text = res
        # ~12 % of words are ignore-tagged (the ICDAR '###' convention,
        # src/data_loaders.py:260-289) — evaluators must not count them
        ignore = rng.rand() < 0.12
        words.append((poly, "###" if ignore else text))
    _distractors(rng, img, occupied, size)
    return img, words


def _coords(poly) -> str:
    return ",".join(f"{v:.1f}" for v in np.asarray(poly).reshape(-1))


def _write_dataset(out_dir: str, n_train: int, n_test: int,
                   test_offset: int, sample, gt_name: str) -> dict:
    """Make ``n_train`` then ``n_test`` samples with ``sample()`` -> (BGR
    image, GT lines), writing ``img{id}.jpg`` and its GT file
    (``gt_name.format(id)``) under ``out_dir``; the test ids start at
    ``test_offset``. Returns the four directories."""
    import cv2

    dirs = {
        "train_dir": os.path.join(out_dir, "train_images"),
        "test_dir": os.path.join(out_dir, "test_images"),
        "train_gt_dir": os.path.join(out_dir, "train_gts"),
        "test_gt_dir": os.path.join(out_dir, "test_gts"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for split, count, offset in (("train", n_train, 0),
                                 ("test", n_test, test_offset)):
        for i in range(count):
            img, lines = sample()
            img_id = offset + i
            cv2.imwrite(os.path.join(dirs[f"{split}_dir"],
                                     f"img{img_id}.jpg"), img)
            with open(os.path.join(dirs[f"{split}_gt_dir"],
                                   gt_name.format(img_id)), "w") as f:
                f.write("\n".join(lines) + "\n")
    return dirs


def generate_hard(out_dir: str, n_train: int = 1600, n_test: int = 400,
                  size: int = 640, seed: int = 7,
                  text_engine=None) -> dict:
    """The hard benchmark in TotalText format: curved CTW-style words,
    rotations to +-50 degrees, small text, '###' ignore tags and text-like
    distractors. The same ``seed`` gives the same images under one cv2, so
    the committed GT pickles of ``demo/hard_bench`` (1600/400 at seed 7,
    cv2 5.0.0) stand for it. ``text_engine`` measures and draws the glyphs
    (``data.text_engine``; cv2's own by default) and sees every image
    before its encode; a ``ReplayTextEngine`` of the committed trace makes
    that GT under any cv2."""
    rng = np.random.RandomState(seed)
    engine = text_engine or CV2_TEXT

    def sample():
        img, words = _render_hard_sample(rng, size=size, engine=engine)
        lines = [f"{_coords(poly)},{text}" for poly, text in words]
        engine.end_image(img, lines)
        return img, lines

    dirs = _write_dataset(out_dir, n_train, n_test, 100000, sample,
                          "gt_img{}.txt")
    return {**dirs, "ignore_tags": ["###"]}


def _ctw_line(rng, img, occupied, size, engine=CV2_TEXT):
    """One text line (1 to 3 words) along a straight to strongly bent
    baseline, glyph by glyph with the tangent's rotation; its GT is the
    CTW1500 14-point line polygon (7 top, 7 bottom), what the reference's
    CTW row evaluates (``README.md:91``)."""
    import cv2

    words = ["".join(rng.choice(list(_UPPER))
                     for _ in range(rng.randint(3, 7)))
             for _ in range(rng.randint(1, 4))]
    text = " ".join(words)
    font_scale = rng.uniform(0.6, 1.1)
    thickness = 1 + int(font_scale)
    dark = rng.rand() < 0.7
    color = tuple(int(v) for v in (rng.randint(0, 50, 3) if dark
                                   else rng.randint(200, 255, 3)))
    (tw, th), _ = engine.text_size(text, cv2.FONT_HERSHEY_SIMPLEX,
                                   font_scale, thickness)
    length = int(tw * 1.1)
    # half the lines are straight / nearly straight, half bent
    amp = (rng.uniform(0.0, 0.25) if rng.rand() < 0.5
           else rng.uniform(0.4, 1.0)) * th * 2 * rng.choice([-1, 1])
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
        if ch == " ":
            continue
        t = (i + 0.5) / n
        cx, cy = base(t)
        dy = amp * np.pi * np.cos(t * np.pi) / length
        ang = -np.degrees(np.arctan2(dy, 1.0))
        patch, mask = _glyph_patch(rng, ch, font_scale, color, thickness,
                                   engine)
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


def generate_hard_ctw(out_dir: str, n_train: int = 1600, n_test: int = 400,
                      size: int = 640, seed: int = 11) -> dict:
    """The line-level benchmark in CTW1500 format: curved and straight
    lines of words over distractor clutter, each GT line ``x,y,w,h`` and
    28 int offsets from (x, y) (``src/data_loaders.py:218-253``). CTW1500
    has no ignore tag, so none is written."""
    rng = np.random.RandomState(seed)

    def sample():
        img = _hard_background(rng, size)
        occupied: list = []
        lines = []
        n_lines = rng.randint(2, 7)
        tries = 0
        while len(lines) < n_lines and tries < 80:
            tries += 1
            res = _ctw_line(rng, img, occupied, size)
            if res is not None:
                lines.append(res[0])
        _distractors(rng, img, occupied, size)
        rows = []
        for poly in lines:
            ipoly = np.round(poly).astype(np.int64)
            x1, y1 = int(ipoly[:, 0].min()), int(ipoly[:, 1].min())
            w = int(ipoly[:, 0].max()) - x1
            h = int(ipoly[:, 1].max()) - y1
            offs = (ipoly - np.array([x1, y1])).reshape(-1)
            rows.append(",".join(map(str, [x1, y1, w, h] + offs.tolist())))
        return img, rows

    dirs = _write_dataset(out_dir, n_train, n_test, 100000, sample,
                          "img{}.txt")
    return {**dirs, "ignore_tags": []}


def generate(out_dir: str, n_train: int = 8, n_test: int = 4,
             size: int = 640, seed: int = 0,
             curved_prob: float = 0.0) -> dict:
    """A TotalText-format dataset under ``out_dir``; ``curved_prob`` mixes
    in CTW1500-style curved 14-point words. Returns the ``data.<name>``
    config section pointing at it."""
    rng = np.random.RandomState(seed)

    def sample():
        img, polys = _render_sample(rng, size=size, curved_prob=curved_prob)
        return img, [f"{_coords(p)},word" for p in polys]

    dirs = _write_dataset(out_dir, n_train, n_test, 1000, sample,
                          "gt_img{}.txt")
    return {**dirs, "ignore_tags": ["###"]}
