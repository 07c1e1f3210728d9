"""The host input pipeline: batching and a thread-prefetching loader.

Port of ``_stack_batch`` and ``DataLoader`` from
``db_text_minimal_tpu/data/datasets.py``. The loader takes any dataset with
``__len__`` and ``__getitem__`` returning sample dicts (``img`` and the four
GT maps, float32 or the compact layout that ``train.trainer.device_preprocess``
unpacks). The cv2 datasets and augmentation are not ported yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np


def _stack_batch(samples: list[dict]) -> dict[str, Any]:
    """Stack the samples' maps into batch arrays; annotations ride along as
    per-image lists."""
    batch: dict[str, Any] = {}
    for key in ("img", "prob_map", "supervision_mask", "thresh_map",
                "text_area_map"):
        batch[key] = np.stack([s[key] for s in samples])
    batch["image_path"] = [s["image_path"] for s in samples]
    if "anns" in samples[0]:
        batch["anns"] = [s["anns"] for s in samples]
        batch["ignore_tags"] = [s["ignore_tags"] for s in samples]
    return batch


class DataLoader:
    """Deterministic, thread-prefetching loader: each epoch a new seeded
    permutation when shuffling, ``drop_last`` (default: when shuffling)
    keeping every batch the same shape. The JAX loader's per-host sharding
    waits for data parallelism (ROADMAP item 17)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 42, drop_last: bool | None = None,
                 prefetch: int = 2, num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = shuffle if drop_last is None else drop_last
        self.prefetch = prefetch
        # samples are made in a thread pool: image decode and the C++
        # geometry library release the GIL, and threads need no fork
        self.num_workers = num_workers
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict[str, Any]]:
        order = self._indices()
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self.epoch
        self.epoch += 1
        n_batches = len(self)

        pool = None
        if self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def fetch(indices):
            if pool is None:
                return [self.dataset[int(i)] for i in indices]
            return list(pool.map(lambda i: self.dataset[int(i)], indices))

        def batches():
            try:
                for b in range(n_batches):
                    idx = order[b * self.batch_size:
                                (b + 1) * self.batch_size]
                    yield _stack_batch(fetch(idx))
            finally:
                if pool is not None:
                    pool.shutdown(wait=False)

        if self.prefetch <= 0:
            yield from batches()
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list[BaseException] = []

        def producer():
            try:
                for batch in batches():
                    q.put(batch)
            except BaseException as e:  # surfaced on the consumer side
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                return
            yield item
