"""Record cv2's text engine over the hard benchmark, for replay elsewhere.

The committed GT of the hard benchmark (``demo/hard_bench/result_poly_gts
.pkl``) was made under cv2 5.0.0, whose text engine sizes the glyphs; under
another cv2 the same seed draws other words. This runs
``generate_hard(n_train=1600, n_test=400, size=640, seed=7)`` under a
``RecordingTextEngine`` (``data.text_engine``), checks that the test GT it
made equals the committed pickle for all 400 images (parsed and exported by
``make_eval.export_gts`` in the order of ``demo/hard_bench/img_fns.pkl``),
and only then writes the trace. It refuses a cv2 whose major version is
not 5. ``make_synthetic --hard --text_trace TRACE`` replays it under any
cv2.

Usage::

    python -m db_text_minimal_tpu_torch.cli.record_text_engine \\
        [--out demo/hard_bench_torch/text_engine_hard_seed7.npz] \\
        [--work_dir DIR]

The 2000 images (about 357 MB) go to a temporary directory (under
``--work_dir`` where given) and are deleted at the end.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import tempfile
from argparse import Namespace

from ..data.synthetic import generate_hard
from ..data.text_engine import RecordingTextEngine
from .make_eval import export_gts

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "demo", "hard_bench")
TRACE = os.path.join(REPO, "demo", "hard_bench_torch",
                     "text_engine_hard_seed7.npz")
HARD_ARGS = {"n_train": 1600, "n_test": 400, "size": 640, "seed": 7}


def committed_gt_equal(data_dir: str, work_dir: str) -> tuple[int, int]:
    """How many of the committed hard-bench test images have, in
    ``data_dir``'s test split, the committed GT: (equal, total)."""
    with open(os.path.join(BENCH, "img_fns.pkl"), "rb") as f:
        img_fns = pickle.load(f)
    with open(os.path.join(BENCH, "result_poly_gts.pkl"), "rb") as f:
        ref = pickle.load(f)
    args = Namespace(dataset="totaltext", ignore_tags=["###"],
                     image_dir=os.path.join(data_dir, "test_images"),
                     gt_dir=os.path.join(data_dir, "test_gts"),
                     gts_fp=os.path.join(work_dir, "gts.pkl"))
    export_gts(args, [os.path.join(args.image_dir, n) for n in img_fns])
    with open(args.gts_fp, "rb") as f:
        got = pickle.load(f)
    if not len(img_fns) == len(ref) == len(got):
        raise ValueError(f"{len(got)} GT entries for {len(img_fns)} images "
                         f"and {len(ref)} committed")
    return sum(g == r for g, r in zip(got, ref)), len(ref)


def record(out: str, work_dir: str) -> dict:
    """Record the hard benchmark's text engine into ``out`` (see the
    module). Returns the trace's header."""
    import cv2

    if cv2.__version__.split(".")[0] != "5":
        raise SystemExit(f"cv2 {cv2.__version__}: the committed GT was made "
                         f"under cv2 5.0.0; record under a cv2 5.x")
    engine = RecordingTextEngine()
    data_dir = os.path.join(work_dir, "hard")
    generate_hard(data_dir, text_engine=engine, **HARD_ARGS)
    equal, total = committed_gt_equal(data_dir, work_dir)
    if equal != total:
        raise SystemExit(f"{equal} of {total} test images have the "
                         f"committed GT under cv2 {cv2.__version__}; no "
                         f"trace written")
    header = {"cv2": cv2.__version__, "generator": "generate_hard",
              "args": HARD_ARGS}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    engine.save(out, header)
    print(f"recorded {len(engine.image_ends)} images "
          f"({len(engine.size_calls)} size calls, {len(engine.draw_calls)} "
          f"draws) under cv2 {cv2.__version__}; the test GT equals the "
          f"committed pickle for {equal} of {total} images; wrote {out} "
          f"({os.path.getsize(out)} bytes)")
    return header


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, default=TRACE)
    parser.add_argument("--work_dir", type=str, default=None,
                        help="the images are made in a temporary directory "
                             "under this one (default: the system's), "
                             "deleted at the end")
    args = parser.parse_args(argv)
    work_dir = tempfile.mkdtemp(prefix="record_text_", dir=args.work_dir)
    try:
        record(args.out, work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
