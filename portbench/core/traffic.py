"""The one traffic generator: a traffic file's parameters and a seed in, a
pool of host batches out.

Two kinds of traffic file are read (``kind``):

- ``train``: ``pool_batches`` distinct batches of ``batch`` scenes at
  ``image_size``², in the port's loader layout: a uint8 NHWC image, the
  binary maps bit-packed along the width (``np.packbits``), the threshold
  map in float16;
- ``serve``: ``pool_batches`` batches of ``batch`` decoded canvases:
  canvas ``i`` is scene ``i mod scenes`` resized to the aspect ratio
  ``w / h`` (one of ``pool_batches · batch`` ratios spaced geometrically
  over [``aspect_min``, ``aspect_max``], the same set for every seed, dealt
  in the seed's order), its longer side ``long_side``, then resized and
  padded to the ``canvas``² square as the port's
  ``utils.test_resize(pad=True)`` does; a uint8 NHWC array.

Scenes come from ``scenes.hard_scene``; scene ``i`` of a seed is drawn from
its own stream, so the pool does not depend on how the work is split over
the worker processes.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import scenes

WORKERS = 6
STREAM_SCENE, STREAM_ORDER = 1, 2


def _train_sample(seed: int, index: int, size: int, max_words: int):
    img, words = scenes.hard_scene(scenes.rng_for(seed, STREAM_SCENE, index),
                                   size, max_words)
    gt, mask, thresh, area = scenes.gt_maps(words, size)
    return {"img": img,
            "prob_map": np.packbits(gt.astype(bool), axis=-1),
            "supervision_mask": np.packbits(mask.astype(bool), axis=-1),
            "thresh_map": thresh.astype(np.float16),
            "text_area_map": np.packbits(area.astype(bool), axis=-1)}


def _scene(seed: int, index: int, size: int, max_words: int):
    return scenes.hard_scene(scenes.rng_for(seed, STREAM_SCENE, index),
                             size, max_words)[0]


def _canvas(img: np.ndarray, aspect: float, long_side: int, canvas: int):
    import cv2

    if aspect >= 1:
        w, h = long_side, int(round(long_side / aspect))
    else:
        w, h = int(round(long_side * aspect)), long_side
    return scenes.resize_pad(cv2.resize(img, (w, h)), canvas)


def serve_aspects(traffic: dict, seed: int) -> np.ndarray:
    """The aspect ratios of the pool's canvases, in the seed's order."""
    n = traffic["pool_batches"] * traffic["batch"]
    ratios = np.geomspace(traffic["aspect_min"], traffic["aspect_max"], n)
    return ratios[scenes.rng_for(seed, STREAM_ORDER).permutation(n)]


def _run(fn, args: list, workers: int) -> list:
    if workers <= 1:
        return [fn(*a) for a in args]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        futures = [pool.submit(fn, *a) for a in args]
        return [f.result() for f in futures]


def make_pool(traffic: dict, seed: int, workers: int = WORKERS) -> list:
    """The traffic's pool of host batches for ``seed``: a list of
    ``pool_batches`` dicts of stacked numpy arrays (``train``) or of uint8
    (batch, canvas, canvas, 3) arrays (``serve``)."""
    n = traffic["pool_batches"] * traffic["batch"]
    words = traffic.get("max_words", 8)
    if traffic["kind"] == "train":
        size = traffic["image_size"]
        samples = _run(_train_sample,
                       [(seed, i, size, words) for i in range(n)], workers)
    elif traffic["kind"] == "serve":
        aspects = serve_aspects(traffic, seed)
        k = traffic["scenes"]
        base = _run(_scene, [(seed, i, traffic["canvas"], words)
                             for i in range(k)], workers)
        samples = [_canvas(base[i % k], float(aspects[i]),
                           traffic["long_side"], traffic["canvas"])
                   for i in range(n)]
    else:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    b = traffic["batch"]
    pool = []
    for j in range(traffic["pool_batches"]):
        chunk = samples[j * b:(j + 1) * b]
        if traffic["kind"] == "train":
            pool.append({k: np.stack([s[k] for s in chunk])
                         for k in chunk[0]})
        else:
            pool.append(np.stack(chunk))
    return pool
