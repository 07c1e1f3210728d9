"""Training data on the host: the datasets, augmentation and loading, GT
label maps, the datasets' GT parsers, synthetic scenes and the synthetic
dataset generators."""

from .datasets import (BaseDataset, CTW1500Dataset, DataLoader, DATASETS,
                       ICDAR2015Dataset, MSRATD500Dataset, TotalTextDataset,
                       build_dataset)
from .labels import draw_thresh_map, make_gt_maps, shrink_polygon
from .parsers import PARSERS

__all__ = [
    "BaseDataset", "CTW1500Dataset", "DataLoader", "DATASETS",
    "ICDAR2015Dataset", "MSRATD500Dataset", "TotalTextDataset",
    "build_dataset", "draw_thresh_map", "make_gt_maps", "shrink_polygon",
    "PARSERS",
]
