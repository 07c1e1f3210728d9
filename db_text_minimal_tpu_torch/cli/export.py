"""Export CLI: a checkpoint -> a ``.pt2`` serving archive
(``serve/export``).

Port of ``db_text_minimal_tpu/cli/export.py``. The default archive has a
symbolic batch, the fused inference head and a uint8 input graph that
subtracts the Caffe means itself: the configuration live serving runs. A
pruned checkpoint exports at its widths (its ``.widths.json``). The archive
is tied to the torch version and the device type that wrote it.

Usage::

    python -m db_text_minimal_tpu_torch.cli.export \
        --model_path model.pth --out models/db.pt2 \
        [--height 640 --width 640] [--batch N] [--no_fuse_head]
        [--float_input] [--infer_mode flax|folded|int8] [--prob_only]
        [--device cpu]
"""

from __future__ import annotations

import argparse

from ..models.prune import load_widths
from ..serve.export import export_model
from .common import INFER_MODES, load_model, load_state_dict, neck_of


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--backbone", type=str, default="resnet18")
    parser.add_argument("--out", type=str, default="./models/db.pt2")
    parser.add_argument("--batch", type=int, default=None,
                        help="fixed batch size; default: symbolic (any)")
    parser.add_argument("--height", type=int, default=640)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--no_fuse_head", action="store_true",
                        help="export the plain DBHead instead of the "
                             "weight-equivalent fused inference head")
    parser.add_argument("--float_input", action="store_true",
                        help="f32 mean-subtracted input instead of uint8 "
                             "with the mean subtracted in the graph")
    parser.add_argument("--infer_mode", type=str, default="flax",
                        choices=INFER_MODES,
                        help="folded: BN-folded forward; int8 additionally "
                             "quantizes the wide convs (requires the fused "
                             "head)")
    parser.add_argument("--prob_only", action="store_true",
                        help="export the prob-map-only graph (channel 0 is "
                             "all the detection postprocess reads)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    if args.infer_mode != "flax" and args.no_fuse_head:
        parser.error("--infer_mode folded/int8 requires the fused head")
    if args.infer_mode == "flax":
        source = load_model(args.model_path, device=args.device,
                            backbone=args.backbone,
                            fuse_head=not args.no_fuse_head)
    else:
        source = load_state_dict(args.model_path, fuse_head=True)
        if args.backbone != "resnet18" or neck_of(source) != "FPN":
            parser.error("--infer_mode folded/int8 supports the flagship "
                         "resnet18 + FPN")
    path = export_model(
        source, args.out, input_shape=(args.batch, args.height, args.width,
                                       3),
        uint8_input=not args.float_input, infer_mode=args.infer_mode,
        prob_only=args.prob_only, device=args.device,
        widths=load_widths(args.model_path))
    print(f"exported to {path} (+ {path}.meta.json)")
    return path


if __name__ == "__main__":
    main()
