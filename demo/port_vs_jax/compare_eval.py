"""The port's evaluation against the JAX package's on one trained
checkpoint, on the CPU (ROADMAP queue 3, items 2 and 3).

Both packages' ``quality_bench.full_eval`` run on the same weights-only
``.pth`` (reference keys; ``card_rows.py`` trains it on the GPU) and the
same test images of the committed hard bench (``make_synthetic --hard``,
seed 7), each writing ``--dump_eval_dir`` files: ``batch_NNN.npz`` (the
preds) and ``batch_NNN.boxes.pkl`` (every row's boxes and scores). The
dumps are compared batch by batch (the maps' gaps; per row, the images
whose boxes match in number and lie within 1 px), and the four rows
(``host``, ``device``, ``host_poly``, ``device_poly``) side by side.

Item 2: the JAX package's connected components stop after 64 rounds
(``ops/pallas/cc.py:64``); the port's run to convergence. On each test
map's device mask (prob > thresh, 8-connected) and its background
(4-connected, for the hole-filled score) the JAX labelling at 64 rounds
is held to the one at 4096; the JAX device rows are then evaluated again
on the JAX preds with the cap at 4096 (a process of its own, so that no
jit cache holds the capped trace) to give the cap's DetEval effect.

Run from the repository root (JAX on the CPU)::

    JAX_PLATFORMS=cpu python demo/port_vs_jax/compare_eval.py \\
        --pth chiprun_out/pvj/flagship.pth --data_dir tmp/hb \\
        --work tmp/compare_eval --out demo/port_vs_jax/compare_eval.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

ROWS = ("host", "device", "host_poly", "device_poly")
UNCAPPED = 4096


def _args(qb, data_dir: str, pth: str, dump: str, batch: int, extra=()):
    return qb.load_args(["--data_dir", data_dir, "--out", "unused.json",
                         "--eval_only", "--checkpoint", pth, "--polygon",
                         "--test_batch_size", str(batch),
                         "--dump_eval_dir", dump, *extra])


def jax_eval(data_dir: str, pth: str, dump: str, batch: int,
             forward_dir: str | None = None) -> dict:
    """The JAX package's ``full_eval`` on the ``.pth``; with
    ``forward_dir``, on the preds dumped there instead of a forward."""
    import jax.numpy as jnp

    from db_text_minimal_tpu.cli import quality_bench as qb
    from db_text_minimal_tpu.data import DataLoader, build_dataset
    from db_text_minimal_tpu.train.checkpoints import load_params_any
    from db_text_minimal_tpu.train.trainer import Trainer

    args = _args(qb, data_dir, pth, dump, batch)
    cfg = qb.build_cfg(args)
    test_loader = DataLoader(build_dataset(cfg, is_training=False), batch)
    trainer = Trainer(cfg, None, test_loader)
    state = trainer.init_state()
    v = load_params_any(pth)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"])
    forward = None
    if forward_dir:
        files = iter(sorted(glob.glob(os.path.join(forward_dir,
                                                   "batch_*.npz"))))

        def forward(device_batch):
            return jnp.asarray(np.load(next(files))["preds"])

    return qb.full_eval(trainer, state, test_loader, args, forward=forward)


def port_eval(data_dir: str, pth: str, dump: str, batch: int) -> dict:
    """The port's ``full_eval`` on the ``.pth``, on the CPU (f32)."""
    from db_text_minimal_tpu_torch.cli import quality_bench as qb
    from db_text_minimal_tpu_torch.data import DataLoader, build_dataset
    from db_text_minimal_tpu_torch.train.trainer import Trainer

    args = _args(qb, data_dir, pth, dump, batch, ["--device", "cpu"])
    cfg = qb.build_cfg(args)
    test_loader = DataLoader(build_dataset(cfg, is_training=False), batch)
    trainer = Trainer(cfg, None, test_loader)
    state = trainer.resume_state(pth)
    return qb.full_eval(trainer, state, test_loader, args)


def _same_boxes(a, b, tol: float = 1.0) -> bool:
    """One image's boxes: the same number, each within ``tol`` px (every
    vertex) of the other's box at the same place, scores within 1e-3."""
    boxes_a, scores_a = a
    boxes_b, scores_b = b
    if len(boxes_a) != len(boxes_b):
        return False
    for pa, pb in zip(boxes_a, boxes_b):
        pa, pb = np.asarray(pa, float), np.asarray(pb, float)
        if pa.shape != pb.shape or np.abs(pa - pb).max() > tol:
            return False
    return bool(np.allclose(np.asarray(scores_a, float),
                            np.asarray(scores_b, float), atol=1e-3))


def compare_dumps(jax_dir: str, port_dir: str) -> dict:
    """Batch by batch: the preds' gaps and, per row, the images whose
    boxes match."""
    batches = sorted(glob.glob(os.path.join(jax_dir, "batch_*.npz")))
    out: dict = {"batches": len(batches), "preds": [],
                 "same_boxes": {r: 0 for r in ROWS}, "images": 0}
    for name in batches:
        base = os.path.basename(name)[:-4]
        pj = np.load(name)["preds"]
        pp = np.load(os.path.join(port_dir, base + ".npz"))["preds"]
        diff = np.abs(pj - pp)
        out["preds"].append({"batch": base, "max": float(diff.max()),
                             "mean": float(diff.mean())})
        with open(os.path.join(jax_dir, base + ".boxes.pkl"), "rb") as f:
            bj = pickle.load(f)
        with open(os.path.join(port_dir, base + ".boxes.pkl"), "rb") as f:
            bp = pickle.load(f)
        out["images"] += pj.shape[0]
        for row in ROWS:
            (boxes_j, scores_j), (boxes_p, scores_p) = bj[row], bp[row]
            out["same_boxes"][row] += sum(
                _same_boxes((boxes_j[i], scores_j[i]),
                            (boxes_p[i], scores_p[i]))
                for i in range(pj.shape[0]))
    out["preds_max"] = max(p["max"] for p in out["preds"])
    out["preds_mean"] = float(np.mean([p["mean"] for p in out["preds"]]))
    return out


def round_cap(jax_dir: str, thresh: float) -> dict:
    """Item 2: on each map of the JAX dump, the JAX labellings at 64 rounds
    against those at ``UNCAPPED``: the foreground mask 8-connected (the
    device rows' components) and its background 4-connected (their
    hole-filled scores)."""
    import jax.numpy as jnp

    from db_text_minimal_tpu.ops.pallas.cc import connected_components

    differ = {"fg8": [], "bg4": []}
    n = 0
    for name in sorted(glob.glob(os.path.join(jax_dir, "batch_*.npz"))):
        preds = np.load(name)["preds"]
        for i in range(preds.shape[0]):
            mask = preds[i, ..., 0] > thresh
            for key, bitmap, conn in (("fg8", mask, 8), ("bg4", ~mask, 4)):
                b = jnp.asarray(bitmap.astype(np.int32))
                capped = np.asarray(connected_components(
                    b, connectivity=conn))
                full = np.asarray(connected_components(
                    b, num_iters=UNCAPPED, connectivity=conn))
                if not np.array_equal(capped, full):
                    differ[key].append(n)
            n += 1
    return {"maps": n, "fg8_differ": differ["fg8"],
            "bg4_differ": differ["bg4"]}


def uncapped_eval(data_dir: str, pth: str, jax_dir: str, dump: str,
                  batch: int) -> dict:
    """The JAX rows on the JAX preds with every connected-components call
    run to ``UNCAPPED`` rounds."""
    from db_text_minimal_tpu.ops.pallas import cc

    capped = cc.connected_components

    def uncapped(bitmap, num_iters=64, connectivity=8):
        return capped(bitmap, num_iters=UNCAPPED, connectivity=connectivity)

    cc.connected_components = uncapped
    return jax_eval(data_dir, pth, dump, batch, forward_dir=jax_dir)


def rows_of(results: dict) -> dict:
    return {r: {"deteval": results[r]["deteval"],
                "iou_pascal": results[r]["iou_pascal"]}
            for r in ROWS if r in results}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pth", required=True)
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--work", default="tmp/compare_eval")
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--step", choices=("jax", "port", "uncapped"),
                        help="run one step in this process (internal)")
    args = parser.parse_args()
    dirs = {k: os.path.join(args.work, k)
            for k in ("jax", "port", "uncapped")}
    if args.step:
        t0 = time.perf_counter()
        if args.step == "jax":
            res = jax_eval(args.data_dir, args.pth, dirs["jax"], args.batch)
        elif args.step == "port":
            res = port_eval(args.data_dir, args.pth, dirs["port"],
                            args.batch)
        else:
            res = uncapped_eval(args.data_dir, args.pth, dirs["jax"],
                                dirs["uncapped"], args.batch)
        res["wall_s"] = round(time.perf_counter() - t0, 1)
        with open(os.path.join(args.work, f"{args.step}.json"), "w") as f:
            json.dump(res, f, indent=1)
        return 0
    os.makedirs(args.work, exist_ok=True)
    me = [sys.executable, os.path.abspath(__file__), "--pth", args.pth,
          "--data_dir", args.data_dir, "--work", args.work, "--out",
          args.out, "--batch", str(args.batch)]
    results = {}
    for step in ("jax", "port"):
        subprocess.run(me + ["--step", step], check=True)
        with open(os.path.join(args.work, f"{step}.json")) as f:
            results[step] = json.load(f)
    from db_text_minimal_tpu.cli import quality_bench as qb
    thresh = qb.load_args(["--data_dir", ".", "--out", "x"]).thresh
    cap = round_cap(dirs["jax"], thresh)
    subprocess.run(me + ["--step", "uncapped"], check=True)
    with open(os.path.join(args.work, "uncapped.json")) as f:
        results["uncapped"] = json.load(f)
    report = {
        "pth": args.pth, "data_dir": args.data_dir,
        "n_test_images": results["jax"]["n_test_images"],
        "batch": args.batch, "thresh": thresh,
        "rows": {"jax": rows_of(results["jax"]),
                 "port": rows_of(results["port"]),
                 "jax_uncapped": rows_of(results["uncapped"])},
        "deteval_gap_port_minus_jax": {
            r: round(results["port"][r]["deteval"]["hmean"]
                     - results["jax"][r]["deteval"]["hmean"], 4)
            for r in ROWS},
        "dumps": compare_dumps(dirs["jax"], dirs["port"]),
        "round_cap": cap,
        "wall_s": {k: results[k]["wall_s"] for k in results},
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in
                      ("rows", "deteval_gap_port_minus_jax", "round_cap")},
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
