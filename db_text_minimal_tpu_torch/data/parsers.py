"""Ground-truth annotation parsers for the supported datasets.

The port's copy of ``db_text_minimal_tpu/data/parsers.py`` (numpy only):
format-exact rebuilds of the reference's four dataset iterators
(``src/data_loaders.py``), plus the three dataset formats the reference
left as unchecked TODOs (``README.md:100-102``): COCO-Text v2, SynthText,
and ArT 2019.

Reference formats:
- TotalText (:175-211): ``gt_img{id}.txt``, CSV of x,y floats + trailing
  label; polygons with < 3 points dropped.
- CTW1500 (:214-253): ``{id}.txt``, 32 ints per line: x,y,w,h then 28 offsets
  relative to (x, y) forming a 14-point polygon (PSENet-style parse).
- ICDAR2015 (:256-289): ``gt_{id}.txt``, 8 int coords + transcript (which may
  itself contain commas); ignore tag ``###``.
- MSRA-TD500 (:292-347): ``{id}.gt`` rotated rects ``idx dif x y w h θ`` →
  4 corners via rotation about the rect center; difficult (dif=1) skipped.

Each parser returns ``(image_paths, annotations)`` where annotations is a
list (per image) of ``{"poly": [[x, y], ...], "text": str}`` dicts.
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np


def _read_lines(path: str) -> list[str]:
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        return f.readlines()


def _strip_bom(s: str) -> str:
    return s.strip("﻿").strip("\xef\xbb\xbf")


def load_totaltext(img_dir: str, gt_dir: str):
    """``src/data_loaders.py:179-211``."""
    img_fps = sorted(glob.glob(os.path.join(img_dir, "*")))
    gt_fps = []
    for img_fp in img_fps:
        img_id = img_fp.split("/")[-1].replace("img", "").split(".")[0]
        gt_fps.append(os.path.join(gt_dir, "gt_img{}.txt".format(img_id)))
    anns = []
    for gt_fp in gt_fps:
        lines = []
        for line in _read_lines(gt_fp):
            parts = line.strip().split(",")
            label = parts[-1]
            cleaned = [_strip_bom(i) for i in parts]
            num_points = math.floor((len(cleaned) - 1) / 2) * 2
            poly = np.array(list(map(float, cleaned[:num_points]))).reshape(
                (-1, 2)).tolist()
            if len(poly) < 3:
                continue
            lines.append({"poly": poly, "text": label})
        anns.append(lines)
    return img_fps, anns


def load_ctw1500(img_dir: str, gt_dir: str):
    """``src/data_loaders.py:218-253``."""
    img_fps = sorted(glob.glob(os.path.join(img_dir, "*")))
    gt_fps = [os.path.join(gt_dir, "{}.txt".format(fp.split("/")[-1][:-4]))
              for fp in img_fps]
    anns = []
    for gt_fp in gt_fps:
        lines = []
        for line in _read_lines(gt_fp):
            gt = _strip_bom(line.strip())
            if not gt:
                continue
            vals = list(map(int, gt.split(",")))
            x1, y1 = vals[0], vals[1]
            bbox = np.asarray(vals[4:32]) + np.array([x1, y1] * 14)
            lines.append({"poly": bbox.reshape(-1, 2).tolist(),
                          "text": "True"})
        anns.append(lines)
    return img_fps, anns


def load_icdar2015(img_dir: str, gt_dir: str):
    """``src/data_loaders.py:260-289`` (note: the reference does NOT sort
    image paths here; we sort for determinism across hosts)."""
    img_fps = sorted(glob.glob(os.path.join(img_dir, "*")))
    gt_fps = [os.path.join(gt_dir,
                           "gt_{}.txt".format(fp.split("/")[-1].split(".")[0]))
              for fp in img_fps]
    anns = []
    for gt_fp in gt_fps:
        lines = []
        for line in _read_lines(gt_fp):
            gt = _strip_bom(line.strip()).split(",")
            if len(gt) < 9:
                continue
            label = ",".join(gt[8:])
            poly = np.asarray(list(map(int, gt[:8]))).reshape(-1, 2).tolist()
            lines.append({"poly": poly, "text": label})
        anns.append(lines)
    return img_fps, anns


def _rotate_points(points, center, theta):
    """``src/data_loaders.py:296-313`` (note the reference negates θ and
    int-truncates the rotated corners)."""
    theta = -theta
    x_c, y_c = center
    out = []
    for x, y in points:
        x_new = x_c + (x - x_c) * np.cos(theta) + (y - y_c) * np.sin(theta)
        y_new = y_c - (x - x_c) * np.sin(theta) + (y - y_c) * np.cos(theta)
        out.append((int(x_new), int(y_new)))
    return out


def load_msra_td500(img_dir: str, gt_dir: str | None = None):
    """``src/data_loaders.py:315-347`` (gt files live next to the images)."""
    img_fps = sorted(glob.glob(os.path.join(img_dir, "*.JPG")))
    gt_fps = sorted(glob.glob(os.path.join(img_dir, "*.gt")))
    anns = []
    for gt_fp in gt_fps:
        lines = []
        for line in _read_lines(gt_fp):
            vals = list(map(float, line.strip().split()))
            if len(vals) < 7:
                continue
            _, dif, x_min, y_min, w, h, theta = vals[:7]
            if int(dif) == 1:  # difficult label
                continue
            corners = [(x_min, y_min), (x_min + w, y_min),
                       (x_min + w, y_min + h), (x_min, y_min + h)]
            center = (x_min + w / 2, y_min + h / 2)
            rot_box = _rotate_points(corners, center, theta)
            lines.append({"poly": np.array(rot_box).tolist(), "text": "True"})
        anns.append(lines)
    return img_fps, anns


def load_cocotext(img_dir: str, gt_dir: str):
    """COCO-Text v2 — unchecked TODO in the reference
    (``README.md:100``); format per the dataset's ``cocotext.v2.json``:
    one JSON with ``imgs`` (id → file_name), ``anns`` (id →
    {image_id, mask, utf8_string, legibility}), ``imgToAnns``.

    ``gt_dir`` is either the JSON file itself or a directory containing
    ``cocotext.v2.json``. Only images actually present in ``img_dir`` are
    returned; non-legible words become ignore entries (text ``###``) so
    the standard ``ignore_tags`` machinery applies.
    """
    import json

    gt_path = gt_dir
    if os.path.isdir(gt_dir):
        cands = sorted(glob.glob(os.path.join(gt_dir, "*.json")))
        if not cands:
            raise FileNotFoundError(f"no COCO-Text json under {gt_dir}")
        gt_path = cands[0]
    with open(gt_path, "r", encoding="utf-8") as f:
        gt = json.load(f)
    img_to_anns = gt.get("imgToAnns", {})
    all_anns = gt.get("anns", {})
    img_fps, anns = [], []
    for img_id, meta in sorted(gt.get("imgs", {}).items(),
                               key=lambda kv: str(kv[1].get("file_name"))):
        fp = os.path.join(img_dir, meta["file_name"])
        if not os.path.exists(fp):
            continue
        lines = []
        for ann_id in img_to_anns.get(str(img_id), []):
            ann = all_anns.get(str(ann_id))
            if ann is None:
                continue
            mask = ann.get("mask", [])
            poly = np.asarray(mask, np.float64).reshape(-1, 2).tolist()
            if len(poly) < 3:
                continue
            text = ann.get("utf8_string", "") or ""
            if ann.get("legibility", "legible") != "legible" or not text:
                text = "###"
            lines.append({"poly": poly, "text": text})
        img_fps.append(fp)
        anns.append(lines)
    return img_fps, anns


def load_synthtext(img_dir: str, gt_dir: str):
    """SynthText — unchecked TODO in the reference (``README.md:101``);
    format per the dataset's ``gt.mat``: MATLAB arrays ``imnames`` (1, N),
    ``wordBB`` (1, N) of 2×4×M corner stacks (2×4 when M == 1), and
    ``txt`` (1, N) of whitespace-joined word blocks.

    ``gt_dir`` is the ``gt.mat`` file or a directory containing it;
    ``img_dir`` is the SynthText root the relative ``imnames`` resolve
    against. Missing images are skipped (the full set is 850k images —
    partial local subsets are the common case).
    """
    from scipy.io import loadmat

    gt_path = gt_dir
    if os.path.isdir(gt_dir):
        gt_path = os.path.join(gt_dir, "gt.mat")
    mat = loadmat(gt_path, squeeze_me=False, simplify_cells=False)
    imnames, wordbb, txt = mat["imnames"][0], mat["wordBB"][0], mat["txt"][0]
    img_fps, anns = [], []
    for i in range(len(imnames)):
        name = str(np.asarray(imnames[i]).reshape(-1)[0])
        fp = os.path.join(img_dir, name)
        if not os.path.exists(fp):
            continue
        bb = np.asarray(wordbb[i], np.float64)
        if bb.ndim == 2:  # single word: (2, 4) → (2, 4, 1)
            bb = bb[:, :, None]
        words = []
        for block in np.asarray(txt[i]).reshape(-1):
            words.extend(str(block).split())
        lines = []
        for j in range(bb.shape[2]):
            poly = bb[:, :, j].T.tolist()  # (4, 2) clockwise corners
            text = words[j] if j < len(words) else "###"
            lines.append({"poly": poly, "text": text})
        img_fps.append(fp)
        anns.append(lines)
    return img_fps, anns


def load_art2019(img_dir: str, gt_dir: str):
    """ArT 2019 — unchecked TODO in the reference (``README.md:102``);
    format per the challenge's ``train_labels.json``: a dict keyed by the
    image stem (``gt_123`` for ``gt_123.jpg``), each value a list of
    ``{"points": [[x, y], ...], "transcription": str,
    "illegibility": bool}``.

    ``gt_dir`` is the JSON file or a directory containing one. Arbitrary
    vertex counts (curved text) pass through; illegible entries become
    ignore entries (``###``).
    """
    import json

    gt_path = gt_dir
    if os.path.isdir(gt_dir):
        cands = sorted(glob.glob(os.path.join(gt_dir, "*.json")))
        if not cands:
            raise FileNotFoundError(f"no ArT json under {gt_dir}")
        gt_path = cands[0]
    with open(gt_path, "r", encoding="utf-8") as f:
        gt = json.load(f)
    img_fps, anns = [], []
    for img_fp in sorted(glob.glob(os.path.join(img_dir, "*"))):
        stem = os.path.basename(img_fp).rsplit(".", 1)[0]
        entries = gt.get(stem)
        if entries is None:
            continue
        lines = []
        for e in entries:
            poly = np.asarray(e.get("points", []), np.float64).tolist()
            if len(poly) < 3:
                continue
            text = e.get("transcription", "") or "###"
            if e.get("illegibility", False):
                text = "###"
            lines.append({"poly": poly, "text": text})
        img_fps.append(img_fp)
        anns.append(lines)
    return img_fps, anns


PARSERS = {
    "totaltext": load_totaltext,
    "ctw1500": load_ctw1500,
    "icdar2015": load_icdar2015,
    "msra_td500": load_msra_td500,
    "cocotext": load_cocotext,
    "synthtext": load_synthtext,
    "art2019": load_art2019,
}
