"""The YAML configuration: defaults, file and overrides.

Port of ``db_text_minimal_tpu/config.py``. One dot-accessible config whose
keys and values mirror the reference's ``example_config.yaml``; missing keys
read as ``None``. ``meta.device`` names a torch device and defaults to
``"cuda"``. The ``parallel`` section is kept so that one file configures
both packages; a single card ignores it. ``yaml`` is imported only where a
file is read or written.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Mapping


class ConfigNode(dict):
    """A dict with attribute access; missing keys return ``None`` like
    hydra/omegaconf ``strict=False`` lookups in the reference."""

    def __getattr__(self, name: str) -> Any:
        if name.startswith("__"):
            raise AttributeError(name)
        value = self.get(name)
        if isinstance(value, dict) and not isinstance(value, ConfigNode):
            value = ConfigNode(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getitem__(self, key):
        value = dict.get(self, key)
        if isinstance(value, dict) and not isinstance(value, ConfigNode):
            value = ConfigNode(value)
            dict.__setitem__(self, key, value)
        return value


def _deep_update(base: dict, overrides: Mapping) -> dict:
    for key, value in overrides.items():
        if (
            isinstance(value, Mapping)
            and isinstance(base.get(key), Mapping)
        ):
            _deep_update(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def _dataset_section(train_dir="", test_dir="", train_gt_dir="",
                     test_gt_dir="", ignore_tags=()):
    return {
        "train_dir": train_dir,
        "test_dir": test_dir,
        "train_gt_dir": train_gt_dir,
        "test_gt_dir": test_gt_dir,
        "ignore_tags": list(ignore_tags),
    }


def default_config() -> ConfigNode:
    """Defaults mirroring the reference ``example_config.yaml``: all its
    sections, keys and values, with ``meta.device`` a torch device."""
    return ConfigNode({
        "meta": {
            "root_dir": ".",
            "debug": False,
            "device": "cuda",
            "test_device": "cpu",
        },
        "hps": {
            "batch_size": 4,
            "test_batch_size": 1,      # must be 1 to evaluate box metrics
            "img_size": 640,
            "no_epochs": 100,
            "warmup_epochs": 10,
            "no_classes": 2,
            "log_iter": 50,
        },
        "lrs": {
            "mode": "reduce",          # reduce / poly
            "warmup_iters": 10,
            # poly decay horizon in steps; 0 reproduces the reference quirk
            # (instantiated without max_iters -> decays to 0 after warmup)
            "max_iters": 0,
            "factor": 0.2,
            "patience": 4,
        },
        "augmentation": None,
        "callbacks": None,
        "data": {
            "totaltext": _dataset_section(ignore_tags=["#"]),
            "ctw1500": _dataset_section(ignore_tags=[]),
            "icdar2015": _dataset_section(ignore_tags=["###"]),
            "msra_td500": _dataset_section(ignore_tags=[]),
            "synthetic": _dataset_section(ignore_tags=["###"]),
            # beyond-reference formats (its unchecked TODOs,
            # reference README.md:100-102)
            "cocotext": _dataset_section(ignore_tags=["###"]),
            "synthtext": _dataset_section(ignore_tags=["###"]),
            "art2019": _dataset_section(ignore_tags=["###"]),
        },
        "dataset": {
            "name": "totaltext",
            "return_dict": True,
        },
        "logging": {
            "logger_file": "train.log",
            "log_dir": "logs",
        },
        "loss": None,
        "model": {
            "backbone": "resnet18",
            "neck": "FPN",
            "head": "DBHead",
            "finetune_cp_path": None,
            "pretrained_backbone_path": None,  # torchvision resnet .pth
            "best_cp_path": "models/best_cp.ckpt",
            "last_cp_path": "models/last_cp.ckpt",
            "best_hmean_cp_path": "models/best_hmean_cp.ckpt",
        },
        "optimizer": {
            "type": "adam",
            "lr": 0.005,
            "lr_finetune": 0.001,
            "weight_decay": 0.0,
            # true per-pixel OHEM; 'mean' is the reference's degenerate form
            "reduction": "none",
            "alpha": 1,
            "beta": 10,
            "negative_ratio": 3,
            "amsgrad": False,
            # deformable backbones only: LR multiplier of the DCN
            # sampling-offset branch (train.trainer.make_optimizer)
            "dcn_offset_lr_mult": 1.0,
        },
        "metric": {
            "thred_text_score": 0.25,
            "prob_threshold": 0.50,
            "unclip_ratio": 1.50,
            "is_output_polygon": True,
            # rect-mode eval: True = the on-device box extractor
            # (DeviceBoxRepresenter), False = the host representer
            "device_boxes": True,
            # the same choice for the per-epoch eval inside training
            "device_boxes_in_train": True,
        },
        "parallel": {
            "data_axis": "data",
            "num_devices": None,       # None = all visible devices
            "compute_dtype": "bfloat16",
            "param_dtype": "float32",
        },
        "private": None,
        "scheduler": None,
        "trainer": {
            "seed": 42,
        },
        "training": None,
    })


def load_config(path: str | None = None,
                overrides: Mapping | None = None) -> ConfigNode:
    """Defaults, then ``path`` (or, when it is None, ``config.yaml`` or
    ``example_config.yaml`` in the working directory, if present), then
    ``overrides``."""
    cfg = default_config()
    if path is None:
        for candidate in ("config.yaml", "example_config.yaml"):
            if os.path.exists(candidate):
                path = candidate
                break
    if path is not None and os.path.exists(path):
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        _deep_update(cfg, loaded)
    if overrides:
        _deep_update(cfg, overrides)
    return ConfigNode(cfg)


def save_config(cfg: Mapping, path: str) -> None:
    import yaml

    def plain(obj):
        if isinstance(obj, Mapping):
            return {k: plain(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [plain(v) for v in obj]
        return obj
    with open(path, "w") as f:
        yaml.safe_dump(plain(cfg), f, sort_keys=False)
