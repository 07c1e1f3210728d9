"""Datasets and the host input pipeline.

Port of ``db_text_minimal_tpu/data/datasets.py``: ``BaseDataset`` (the
reference's ``BaseDatasetIter``, ``src/data_loaders.py:18-172``), its seven
subclasses, ``DATASETS``, ``build_dataset``, ``_stack_batch`` and the
thread-prefetching ``DataLoader``. A sample is: imread, BGR to RGB, in
training the flip/rotate/scale augment and the text-safe crop under a
per-(seed, epoch, index) RNG, the square resize-pad to ``image_size``,
invalid polygons dropped, the four GT maps, then either the Caffe means
subtracted in RGB order (float32 NHWC) or the compact layout (uint8 image,
``np.packbits`` maps, f16 threshold map) that
``train.trainer.device_preprocess`` finishes on the device. As in JAX,
``DataLoader`` loads each process's disjoint shard of the global batch,
and ``python -m db_text_minimal_tpu_torch.data.datasets`` draws the GT
overlay of one training sample.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Iterator

import numpy as np

from ..ops import geometry as geo
from ..utils import CAFFE_MEAN
from . import augment as aug
from .labels import make_gt_maps
from .parsers import PARSERS


class BaseDataset:
    """``src/data_loaders.py:18-172``: the samples of one split, read
    through the subclass's GT ``parser``."""

    parser: Callable | None = None

    def __init__(self, train_dir, train_gt_dir, ignore_tags,
                 is_training=True, image_size=640, min_text_size=8,
                 shrink_ratio=0.4, thresh_min=0.3, thresh_max=0.7,
                 mean=CAFFE_MEAN, seed=42, compact_dtypes: bool = False):
        self.train_dir = train_dir
        self.train_gt_dir = train_gt_dir
        self.ignore_tags = list(ignore_tags)
        self.is_training = is_training
        self.image_size = image_size
        self.min_text_size = min_text_size
        self.shrink_ratio = shrink_ratio
        self.thresh_min = thresh_min
        self.thresh_max = thresh_max
        self.mean = np.asarray(mean, dtype=np.float32)
        self.seed = seed
        self.epoch = 0  # set by the loader; feeds the per-sample RNGs
        # compact_dtypes: a uint8 image (the means are subtracted on the
        # device) and bit-packed or f16 maps, 3.5x fewer bytes to upload
        self.compact_dtypes = compact_dtypes

        self.image_paths, self.all_anns = type(self).parser(
            train_dir, train_gt_dir)
        assert len(self.image_paths) == len(self.all_anns)

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, index: int) -> dict[str, Any]:
        import cv2

        image_path = self.image_paths[index]
        anns = [dict(a) for a in self.all_anns[index]]

        img = cv2.imread(image_path)
        if img is None:
            raise FileNotFoundError(image_path)
        img = img[:, :, ::-1]  # BGR -> RGB (src/data_loaders.py:78)

        if self.is_training:
            # a per-(epoch, index) RNG: the same sample whatever the
            # threads' order, a new one each epoch
            rng = np.random.RandomState(
                (self.seed * 1000003 + self.epoch * 9176 + index) % (2**31))
            img, anns = aug.random_flip_rotate_resize(rng, img, anns)
            img, anns = aug.crop(rng, img, anns)
        img, anns = aug.resize_square_pad(self.image_size, img, anns)

        # drop invalid polygons (src/data_loaders.py:86)
        anns = [a for a in anns
                if len(a["poly"]) >= 3 and geo.polygon_is_simple(a["poly"])]

        gt, mask, thresh_map, thresh_mask, ignore_flags = make_gt_maps(
            anns, self.image_size, self.ignore_tags,
            min_text_size=self.min_text_size, shrink_ratio=self.shrink_ratio,
            thresh_min=self.thresh_min, thresh_max=self.thresh_max)

        if self.compact_dtypes:
            # binary maps bit-packed, 8 pixels a byte, where the width
            # allows (device_preprocess unpacks them); thresh in f16
            def pack(m):
                if m.shape[-1] % 8 == 0:
                    return np.packbits(m.astype(bool), axis=-1)
                return m.astype(np.uint8)

            data = {
                "image_path": image_path,
                "img": np.ascontiguousarray(img, np.uint8),
                "prob_map": pack(gt),
                "supervision_mask": pack(mask),
                "thresh_map": thresh_map.astype(np.float16),
                "text_area_map": pack(thresh_mask),
            }
        else:
            data = {
                "image_path": image_path,
                # (H, W, 3) float32 NHWC, the means in RGB order
                "img": img.astype(np.float32) - self.mean,
                "prob_map": gt,
                "supervision_mask": mask,
                "thresh_map": thresh_map,
                "text_area_map": thresh_mask,
            }
        if not self.is_training:
            data["anns"] = [a["poly"] for a in anns]
            data["ignore_tags"] = ignore_flags
        return data


class TotalTextDataset(BaseDataset):
    """``src/data_loaders.py:175-211``."""
    parser = staticmethod(PARSERS["totaltext"])


class CTW1500Dataset(BaseDataset):
    """``src/data_loaders.py:214-253``."""
    parser = staticmethod(PARSERS["ctw1500"])


class ICDAR2015Dataset(BaseDataset):
    """``src/data_loaders.py:256-289``."""
    parser = staticmethod(PARSERS["icdar2015"])


class MSRATD500Dataset(BaseDataset):
    """``src/data_loaders.py:292-347``."""
    parser = staticmethod(PARSERS["msra_td500"])


class COCOTextDataset(BaseDataset):
    """COCO-Text v2 (a TODO of the reference, ``README.md:100``)."""
    parser = staticmethod(PARSERS["cocotext"])


class SynthTextDataset(BaseDataset):
    """SynthText (a TODO of the reference, ``README.md:101``)."""
    parser = staticmethod(PARSERS["synthtext"])


class ArT2019Dataset(BaseDataset):
    """ArT 2019 (a TODO of the reference, ``README.md:102``)."""
    parser = staticmethod(PARSERS["art2019"])


DATASETS = {
    "totaltext": TotalTextDataset,
    "ctw1500": CTW1500Dataset,
    "icdar2015": ICDAR2015Dataset,
    "msra_td500": MSRATD500Dataset,
    "synthetic": TotalTextDataset,  # the generators write TotalText GT
    "cocotext": COCOTextDataset,
    "synthtext": SynthTextDataset,
    "art2019": ArT2019Dataset,
}


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
    keeping every batch the same shape. ``sample_seconds`` holds the wall
    time of each sample made in the last epoch, in its worker thread. With
    ``num_hosts`` > 1 (the processes of a distributed run, ``parallel``)
    process ``host_id`` takes ``order[host_id::num_hosts]`` of each epoch's
    order, a disjoint shard, as the JAX loader does."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 42, num_hosts: int = 1, host_id: int = 0,
                 drop_last: bool | None = None, prefetch: int = 2,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.drop_last = shuffle if drop_last is None else drop_last
        self.prefetch = prefetch
        # samples are made in a thread pool: image decode and the C++
        # geometry library release the GIL, and threads need no fork
        self.num_workers = num_workers
        self.epoch = 0
        self.sample_seconds: list[float] = []

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(
                n)
        else:
            order = np.arange(n)
        return order[self.host_id::self.num_hosts]

    def __len__(self):
        n = len(self._indices())
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
        seconds = self.sample_seconds = []

        def sample(i):
            t0 = time.perf_counter()
            out = self.dataset[int(i)]
            seconds.append(time.perf_counter() - t0)  # atomic in CPython
            return out

        def fetch(indices):
            if pool is None:
                return [sample(i) for i in indices]
            return list(pool.map(sample, indices))

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


def build_dataset(cfg, is_training: bool):
    """The dataset of ``cfg.dataset.name`` from its ``cfg.data`` section
    (``src/train.py:29-74``), in the compact layout: the trainer finishes
    preprocessing on the device."""
    name = cfg.dataset.name
    section = cfg.data[name]
    cls = DATASETS[name]
    return cls(
        section.train_dir if is_training else section.test_dir,
        section.train_gt_dir if is_training else section.test_gt_dir,
        section.ignore_tags,
        is_training=is_training,
        image_size=cfg.hps.img_size,
        seed=cfg.trainer.seed if cfg.trainer else 42,
        compact_dtypes=True,
    )


def _visualize_sample_main():
    """The GT overlay of one training sample (the reference's
    ``src/data_loaders.py:350-393`` ``__main__``): the image scaled to
    uint8, its prob map in jet at 0.35 and its threshold map in jet at 0.5
    over it, saved to ``<root_dir>/tmp/foo.jpg``. The compact layout's
    bit-packed prob map is unpacked first.

    Usage: ``python -m db_text_minimal_tpu_torch.data.datasets
    [config.yaml]``
    """
    import sys

    from ..config import load_config
    from ..utils import minmax_scaler_img
    from ..utils.visualize import overlay

    cfg = load_config(sys.argv[1] if len(sys.argv) > 1 else None)
    dataset = build_dataset(cfg, is_training=True)
    loader = DataLoader(dataset, batch_size=1, shuffle=True, prefetch=0)
    samples = next(iter(loader))
    img = samples["img"][0]
    prob = samples["prob_map"][0]
    if prob.dtype == np.uint8 and prob.shape[-1] * 8 == img.shape[1]:
        prob = np.unpackbits(prob, axis=-1)
    out_dir = os.path.join(cfg.meta.root_dir or ".", "tmp")
    os.makedirs(out_dir, exist_ok=True)
    out = overlay(minmax_scaler_img(img),
                  [(prob, "jet", 0.35),
                   (samples["thresh_map"][0], "jet", 0.5)],
                  os.path.join(out_dir, "foo.jpg"))
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    _visualize_sample_main()
