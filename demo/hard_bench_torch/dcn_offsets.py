"""The learned offsets of a trained deformable detector on one test batch:
for each ``DeformConv``, the quantiles (50, 90, 99, 99.9 %) of |dy| and
|dx| in pixels, and D1's cold times at those offsets and at zero offsets
on the same input, on the card::

    python demo/hard_bench_torch/dcn_offsets.py --checkpoint CKPT \
        --data_dir tmp/hb --out offsets.json

CKPT is a deformable_resnet18 checkpoint of ``quality_bench
--save_checkpoint``; the batch is the first 16 images of the test set, run
through the trainer's eval step as ``quality_bench`` evaluates them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from db_text_minimal_tpu_torch.cli import quality_bench as qb  # noqa: E402
from db_text_minimal_tpu_torch.data import DataLoader, build_dataset  # noqa: E402
from db_text_minimal_tpu_torch.models.deform import DeformConv  # noqa: E402
from db_text_minimal_tpu_torch.ops import deform as DF  # noqa: E402
from db_text_minimal_tpu_torch.train.trainer import Trainer, to_device  # noqa: E402

QUANTILES = (0.5, 0.9, 0.99, 0.999)
BATCH = 16


def kernel_ms(x: torch.Tensor, off: torch.Tensor, stride: int) -> dict:
    """D1's forward and backward (bf16 columns) on these inputs, cold (the
    L2 flushed before each call), mean ms of 10 calls by CUDA events."""
    import chip_smoke

    cols = DF.deform_im2col(x, off, stride, torch.bfloat16)
    # the (9, P, C) view of a (P, 9, C) product, as deform_conv's backward
    # hands it over
    g = torch.randn((cols.shape[1], 9, cols.shape[2]), device=x.device).to(
        torch.bfloat16).transpose(0, 1)
    return {"im2col_ms": chip_smoke.timed(
                lambda: DF.deform_im2col(x, off, stride, torch.bfloat16), 10),
            "col2im_ms": chip_smoke.timed(
                lambda: DF.deform_col2im(x, off, g, stride), 10)}


def offset_stats(model: torch.nn.Module, run) -> list[dict]:
    """Run ``run()`` with a hook on the offset branch of each
    ``DeformConv`` of ``model``; returns one entry per conv, in call order:
    its name, input shape (N, H, W, C), stride, the quantiles of |dy| and
    |dx|, and D1's times at these offsets and at zero offsets on the same
    input."""
    stats, hooks = [], []

    def hook(name, stride):
        def record(conv, args, out):
            x = args[0].permute(0, 2, 3, 1).contiguous()
            off = out.float().permute(0, 2, 3, 1).contiguous()
            q = torch.tensor(QUANTILES, device=off.device)
            stats.append({
                "conv": name, "input": list(x.shape), "stride": stride,
                "abs_dy_quantiles": torch.quantile(
                    off[..., 0::2].abs().flatten(), q).tolist(),
                "abs_dx_quantiles": torch.quantile(
                    off[..., 1::2].abs().flatten(), q).tolist(),
                "trained": kernel_ms(x, off, stride),
                "zero": kernel_ms(x, torch.zeros_like(off), stride)})
        return record

    for name, mod in model.named_modules():
        if isinstance(mod, DeformConv):
            hooks.append(mod.offset_conv.register_forward_hook(
                hook(name, mod.stride)))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return stats


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    qargs = qb.load_args(["--data_dir", args.data_dir, "--out", args.out,
                          "--backbone", "deformable_resnet18", "--eval_only",
                          "--checkpoint", args.checkpoint,
                          "--test_batch_size", str(BATCH)])
    cfg = qb.build_cfg(qargs)
    loader = DataLoader(build_dataset(cfg, is_training=False), BATCH)
    trainer = Trainer(cfg, None, loader)
    state = trainer.resume_state(args.checkpoint)
    batch = to_device(next(iter(loader)), trainer.device)
    stats = offset_stats(state.model,
                         lambda: trainer._eval_step(state, batch))
    report = {"checkpoint": args.checkpoint, "quantiles": QUANTILES,
              "device": torch.cuda.get_device_name(0), "convs": stats}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    for s in stats:
        print(s["conv"], s["input"], "dy", [round(v, 3) for v in
                                            s["abs_dy_quantiles"]],
              "dx", [round(v, 3) for v in s["abs_dx_quantiles"]],
              "ms", s["trained"],
              "at zero offsets", s["zero"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
