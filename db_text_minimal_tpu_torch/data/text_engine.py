"""The text engine of the synthetic generators, as an object they are given.

``data/synthetic.py`` measures and draws its glyphs only through
``cv2.getTextSize`` and a pair of ``cv2.putText`` calls (the glyph in its
colour on zeros, and its mask in 255 on zeros); the glyph set of the
recognizer (``generate_glyphs``) draws its words straight onto the image
(``put_text``, which only ``CV2TextEngine`` and so the recording engine
have: no trace of the glyph set is kept). Those depend on cv2's
version: 4.x and 5.x size and draw the Hershey glyphs differently, so one
seed makes other words under each, and the hard benchmark's committed GT
(``demo/hard_bench/result_poly_gts.pkl``, made under cv2 5.0.0) checks only
under 5.x. Three engines share one interface:

- ``CV2TextEngine`` calls cv2, the generators' default;
- ``RecordingTextEngine`` calls cv2 and keeps, in call order, each size
  call's arguments and result and each mask, then per image the calls'
  extent and SHA-256 digests of its GT lines and of its pixels before the
  encode (``save`` writes the trace);
- ``ReplayTextEngine`` answers from such a trace without calling cv2: the
  recorded sizes, the recorded mask, and the colour patch rebuilt from it
  as ``patch_from_mask`` (``(color * mask + 127) // 255``) plus the
  recorded corrections. cv2 5.x's antialiased ``putText`` draws that rule
  on zeros but for a few pixels, off by one where strokes cross (22 of the
  first 598 calls at seed 7, 1 to 5 pixels each), so the trace keeps
  those pixels' differences and the replay is exact. It checks every
  call's arguments, and every image's GT, against the trace, and raises
  ``TraceMismatch`` with the call's (or the image's) index on the first
  difference or past the end; it never falls back to cv2. It counts the images whose pixels equal the
  recorded ones; ``warpAffine``, the drawing calls and the JPEG encoder
  may still differ between cv2 versions, and the GT does not depend on
  them.

The trace is an ``.npz`` (zip, deflate level 9) that ``numpy.load`` reads.
"""

from __future__ import annotations

import hashlib
import json
import zipfile

import numpy as np

TRACE_FORMAT = 1
_SIZE_KEYS = ("size_text", "size_font", "size_scale", "size_thickness")
_DRAW_KEYS = ("draw_text", "draw_org", "draw_font", "draw_scale",
              "draw_color", "draw_thickness", "draw_shape")


class TraceMismatch(RuntimeError):
    """A replayed call or image that differs from the trace."""


def gt_digest(lines: list[str]) -> str:
    """SHA-256 of an image's GT file as the generators write it."""
    return hashlib.sha256(("\n".join(lines) + "\n").encode()).hexdigest()


def pixel_digest(img: np.ndarray) -> str:
    """SHA-256 of an image's uint8 pixels and shape, before the encode."""
    img = np.ascontiguousarray(img, np.uint8)
    return hashlib.sha256(repr(img.shape).encode()
                          + img.tobytes()).hexdigest()


def patch_from_mask(color: tuple, mask: np.ndarray) -> np.ndarray:
    """The (h, w, 3) int16 colour patch that ``color`` at coverage ``mask``
    (0-255) gives on zeros: ``(color * mask + 127) // 255``."""
    rgb = np.asarray(color, np.int32)
    return ((rgb * mask[..., None].astype(np.int32) + 127)
            // 255).astype(np.int16)


class CV2TextEngine:
    """cv2's own text engine."""

    def text_size(self, text: str, font: int, scale: float,
                  thickness: int):
        """``cv2.getTextSize``: ((width, height), baseline)."""
        import cv2

        return cv2.getTextSize(text, font, scale, thickness)

    def draw(self, shape: tuple, text: str, org: tuple, font: int,
             scale: float, color: tuple, thickness: int):
        """``text`` drawn at ``org`` in ``color`` on a zero (h, w, 3)
        patch, and in 255 on a zero (h, w) mask: (patch, mask)."""
        import cv2

        patch = np.zeros(tuple(shape) + (3,), np.uint8)
        mask = np.zeros(tuple(shape), np.uint8)
        cv2.putText(patch, text, org, font, scale, color, thickness)
        cv2.putText(mask, text, org, font, scale, 255, thickness)
        return patch, mask

    def put_text(self, img: np.ndarray, text: str, org: tuple, font: int,
                 scale: float, color: tuple, thickness: int) -> None:
        """``cv2.putText`` onto ``img`` in place (cv2 5.x blends the
        antialiased glyph over what is there)."""
        import cv2

        cv2.putText(img, text, org, font, scale, color, thickness)

    def end_image(self, img: np.ndarray, lines: list[str]) -> None:
        """Called by a generator after each image, before its encode."""


class RecordingTextEngine(CV2TextEngine):
    """cv2's engine, keeping what a replay needs (see the module)."""

    def __init__(self):
        self.size_calls: list[tuple] = []
        self.size_results: list[tuple] = []
        self.draw_calls: list[tuple] = []
        self.masks: list[np.ndarray] = []
        self.fix_pos: list[np.ndarray] = []
        self.fix_delta: list[np.ndarray] = []
        self._patch_bytes = 0
        self.image_ends: list[tuple[int, int]] = []
        self.gt_sha256: list[str] = []
        self.pixel_sha256: list[str] = []

    def text_size(self, text, font, scale, thickness):
        (w, h), baseline = super().text_size(text, font, scale, thickness)
        self.size_calls.append((text, font, scale, thickness))
        self.size_results.append((w, h, baseline))
        return (w, h), baseline

    def draw(self, shape, text, org, font, scale, color, thickness):
        patch, mask = super().draw(shape, text, org, font, scale, color,
                                   thickness)
        self.draw_calls.append((text, tuple(org), font, scale, tuple(color),
                                thickness, tuple(shape)))
        self.masks.append(mask)
        delta = (patch.astype(np.int16)
                 - patch_from_mask(color, mask)).reshape(-1)
        pos = np.flatnonzero(delta)
        self.fix_pos.append(pos + self._patch_bytes)
        self.fix_delta.append(delta[pos].astype(np.int8))
        self._patch_bytes += patch.size
        return patch, mask

    def end_image(self, img, lines):
        self.image_ends.append((len(self.size_calls), len(self.draw_calls)))
        self.gt_sha256.append(gt_digest(lines))
        self.pixel_sha256.append(pixel_digest(img))

    def arrays(self, header: dict) -> dict:
        """The trace as named arrays; ``header`` (cv2's version and the
        generator's arguments) is stored as JSON."""
        size_cols = list(zip(*self.size_calls)) or [()] * 4
        draw_cols = list(zip(*self.draw_calls)) or [()] * 7
        masks = (np.concatenate([m.reshape(-1) for m in self.masks])
                 if self.masks else np.zeros(0, np.uint8))
        return {
            "header": np.array(json.dumps(
                {**header, "format": TRACE_FORMAT,
                 "n_images": len(self.image_ends)}, sort_keys=True)),
            "size_text": np.array(size_cols[0], dtype=str),
            "size_font": np.array(size_cols[1], np.int8),
            "size_scale": np.array(size_cols[2], np.float64),
            "size_thickness": np.array(size_cols[3], np.int16),
            "size_result": np.array(self.size_results,
                                    np.int32).reshape(-1, 3),
            "draw_text": np.array(draw_cols[0], dtype=str),
            "draw_org": np.array(draw_cols[1], np.int32).reshape(-1, 2),
            "draw_font": np.array(draw_cols[2], np.int8),
            "draw_scale": np.array(draw_cols[3], np.float64),
            "draw_color": np.array(draw_cols[4], np.int16).reshape(-1, 3),
            "draw_thickness": np.array(draw_cols[5], np.int16),
            "draw_shape": np.array(draw_cols[6], np.int32).reshape(-1, 2),
            "masks": masks,
            "patch_fix_pos": np.concatenate(
                [np.zeros(0, np.int64)] + self.fix_pos),
            "patch_fix_delta": np.concatenate(
                [np.zeros(0, np.int8)] + self.fix_delta),
            "image_ends": np.array(self.image_ends, np.int64).reshape(-1, 2),
            "gt_sha256": np.array(self.gt_sha256, dtype="S64"),
            "pixel_sha256": np.array(self.pixel_sha256, dtype="S64"),
        }

    def save(self, path: str, header: dict) -> None:
        """Write the trace to ``path`` as an ``.npz`` at deflate level 9
        (``np.savez_compressed`` takes zlib's default level)."""
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                             compresslevel=9) as zf:
            for name, arr in self.arrays(header).items():
                with zf.open(name + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)


def load_trace(path: str) -> dict:
    """A trace's arrays, and its header parsed under ``"header"``."""
    with np.load(path, allow_pickle=False) as z:
        trace = {k: z[k] for k in z.files}
    trace["header"] = json.loads(str(trace["header"]))
    if trace["header"].get("format") != TRACE_FORMAT:
        raise TraceMismatch(f"{path}: trace format "
                            f"{trace['header'].get('format')}, this reader "
                            f"reads {TRACE_FORMAT}")
    return trace


class ReplayTextEngine:
    """Answers the generators' text-engine calls from a trace (see the
    module). ``trace`` is a path or what ``load_trace`` returns."""

    def __init__(self, trace):
        self.trace = load_trace(trace) if isinstance(trace, str) else trace
        t = self.trace
        self.header = t["header"]
        self.n_images = len(t["image_ends"])
        shapes = t["draw_shape"].astype(np.int64)
        self._mask_start = np.concatenate(
            [[0], np.cumsum(shapes[:, 0] * shapes[:, 1])])
        self.n_size = 0
        self.n_draw = 0
        self.images = 0
        self.pixels_equal = 0

    def _next(self, kind: str, index: int, count: int, got: tuple,
              keys: tuple) -> None:
        if index >= count:
            raise TraceMismatch(f"text-engine {kind} call {index}: past the "
                                f"end of the trace ({count} such calls)")
        want = tuple(self.trace[k][index] for k in keys)
        same = all(np.array_equal(np.asarray(g), np.asarray(w))
                   for g, w in zip(got, want))
        if not same:
            raise TraceMismatch(
                f"text-engine {kind} call {index}: arguments "
                f"{_plain(got)}, the trace has {_plain(want)}")

    def text_size(self, text, font, scale, thickness):
        i = self.n_size
        self._next("size", i, len(self.trace["size_result"]),
                   (text, font, scale, thickness), _SIZE_KEYS)
        self.n_size += 1
        w, h, baseline = (int(v) for v in self.trace["size_result"][i])
        return (w, h), baseline

    def draw(self, shape, text, org, font, scale, color, thickness):
        i = self.n_draw
        self._next("draw", i, len(self.trace["draw_shape"]),
                   (text, tuple(org), font, scale, tuple(color), thickness,
                    tuple(shape)), _DRAW_KEYS)
        self.n_draw += 1
        h, w = (int(v) for v in self.trace["draw_shape"][i])
        start = self._mask_start[i]
        mask = self.trace["masks"][start:start + h * w].reshape(h, w)
        patch = patch_from_mask(color, mask).reshape(-1)
        pos = self.trace["patch_fix_pos"]
        lo, hi = np.searchsorted(pos, [3 * start, 3 * (start + h * w)])
        patch[pos[lo:hi] - 3 * start] += self.trace["patch_fix_delta"][lo:hi]
        return patch.astype(np.uint8).reshape(h, w, 3), mask.copy()

    def end_image(self, img, lines):
        k = self.images
        if k >= self.n_images:
            raise TraceMismatch(f"image {k}: past the end of the trace "
                                f"({self.n_images} images)")
        ends = tuple(int(v) for v in self.trace["image_ends"][k])
        if (self.n_size, self.n_draw) != ends:
            raise TraceMismatch(
                f"image {k}: ends after {self.n_size} size and "
                f"{self.n_draw} draw calls, the trace after {ends}")
        if gt_digest(lines).encode() != self.trace["gt_sha256"][k]:
            raise TraceMismatch(f"image {k}: its GT differs from the "
                                f"trace's")
        self.pixels_equal += (pixel_digest(img).encode()
                              == self.trace["pixel_sha256"][k])
        self.images += 1


def _plain(values: tuple) -> tuple:
    return tuple(v.tolist() if isinstance(v, np.ndarray) else
                 v.item() if isinstance(v, np.generic) else v
                 for v in values)
