"""Generate a synthetic dataset for demos, tests and the quality bench.

Port of ``db_text_minimal_tpu/cli/make_synthetic.py``: the same arguments,
defaults and generators, so a seed writes the same images and GT files, and
the same YAML config section on stdout.

Usage::

    python -m db_text_minimal_tpu_torch.cli.make_synthetic out_dir \\
        [--n_train 8] [--n_test 4] [--size 640] [--seed 0] [--hard | --ctw]

``--hard`` is the hard benchmark (1600/400 at seed 7 by default, the split
whose test GT ``demo/hard_bench/result_poly_gts.pkl`` holds, made under cv2
5.0.0); ``--ctw`` its line-level CTW1500 form (1600/400 at seed 11).

``--hard --text_trace TRACE`` replays a recorded text engine
(``cli.record_text_engine``; the committed one is
``demo/hard_bench_torch/text_engine_hard_seed7.npz``) in place of cv2's, so
the committed GT comes out under any cv2. It takes the trace's counts, size
and seed and refuses others, checks each image's GT against the trace, and
prints on stderr how many images it wrote and how many of them have the
recorded pixels before the encode (cv2's ``warpAffine``, drawing calls and
JPEG encoder may differ between versions; the GT does not depend on them).
"""

from __future__ import annotations

import argparse

import sys

from ..data.synthetic import generate, generate_hard, generate_hard_ctw
from ..data.text_engine import ReplayTextEngine


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir", type=str)
    parser.add_argument("--n_train", type=int, default=None)
    parser.add_argument("--n_test", type=int, default=None)
    parser.add_argument("--size", type=int, default=None,
                        help="default 640")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--hard", action="store_true",
                        help="the hard benchmark (see the module's doc)")
    parser.add_argument("--ctw", action="store_true",
                        help="the CTW1500-format line-level benchmark "
                             "(1600/400 at seed 11)")
    parser.add_argument("--text_trace", type=str, default=None,
                        help="with --hard: replay this recorded text "
                             "engine (see the module's doc)")
    args = parser.parse_args(argv)
    gen = (generate_hard_ctw if args.ctw
           else generate_hard if args.hard else generate)
    defaults = ((1600, 400, 11) if args.ctw
                else (1600, 400, 7) if args.hard else (8, 4, 0))
    kwargs = {}
    if args.text_trace:
        if not args.hard or args.ctw:
            parser.error("--text_trace replays the --hard benchmark only")
        engine = ReplayTextEngine(args.text_trace)
        traced = engine.header["args"]
        for name in ("n_train", "n_test", "size", "seed"):
            given = getattr(args, name)
            if given is not None and given != traced[name]:
                parser.error(f"--{name} {given}: the trace {args.text_trace} "
                             f"was recorded with {name}={traced[name]}")
        defaults = (traced["n_train"], traced["n_test"], traced["seed"])
        args.size = traced["size"]
        kwargs["text_engine"] = engine
    section = gen(
        args.out_dir,
        n_train=args.n_train if args.n_train is not None else defaults[0],
        n_test=args.n_test if args.n_test is not None else defaults[1],
        size=args.size if args.size is not None else 640,
        seed=args.seed if args.seed is not None else defaults[2], **kwargs)
    if args.text_trace:
        print(f"# replayed {args.text_trace} (recorded under cv2 "
              f"{engine.header['cv2']}): wrote {engine.images} images, "
              f"each with the recorded GT; {engine.pixels_equal} of them "
              f"with the recorded pixels before the encode", file=sys.stderr)
    name = "ctw1500" if args.ctw else "synthetic"
    import yaml

    print(yaml.safe_dump({"data": {name: section},
                          "dataset": {"name": name}},
                         sort_keys=False))


if __name__ == "__main__":
    main()
