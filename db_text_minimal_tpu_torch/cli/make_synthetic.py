"""Generate a synthetic dataset for demos, tests and the quality bench.

Port of ``db_text_minimal_tpu/cli/make_synthetic.py``: the same arguments,
defaults and generators, so a seed writes the same images and GT files, and
the same YAML config section on stdout.

Usage::

    python -m db_text_minimal_tpu_torch.cli.make_synthetic out_dir \\
        [--n_train 8] [--n_test 4] [--size 640] [--seed 0] [--hard | --ctw]

``--hard`` is the hard benchmark (1600/400 at seed 7 by default, the split
whose test GT ``demo/hard_bench/result_poly_gts.pkl`` holds); ``--ctw`` its
line-level CTW1500 form (1600/400 at seed 11).
"""

from __future__ import annotations

import argparse

from ..data.synthetic import generate, generate_hard, generate_hard_ctw


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("out_dir", type=str)
    parser.add_argument("--n_train", type=int, default=None)
    parser.add_argument("--n_test", type=int, default=None)
    parser.add_argument("--size", type=int, default=640)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--hard", action="store_true",
                        help="the hard benchmark (see the module's doc)")
    parser.add_argument("--ctw", action="store_true",
                        help="the CTW1500-format line-level benchmark "
                             "(1600/400 at seed 11)")
    args = parser.parse_args(argv)
    gen = (generate_hard_ctw if args.ctw
           else generate_hard if args.hard else generate)
    defaults = ((1600, 400, 11) if args.ctw
                else (1600, 400, 7) if args.hard else (8, 4, 0))
    section = gen(
        args.out_dir,
        n_train=args.n_train if args.n_train is not None else defaults[0],
        n_test=args.n_test if args.n_test is not None else defaults[1],
        size=args.size,
        seed=args.seed if args.seed is not None else defaults[2])
    name = "ctw1500" if args.ctw else "synthetic"
    import yaml

    print(yaml.safe_dump({"data": {name: section},
                          "dataset": {"name": name}},
                         sort_keys=False))


if __name__ == "__main__":
    main()
