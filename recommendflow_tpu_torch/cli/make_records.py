"""CLI: build RFB record files from CSVs or synthetic data (the counterpart
of `recommendflow_tpu/cli/make_records.py`; the same flags, and the same
bytes for the same inputs).

Usage:
    python -m recommendflow_tpu_torch.cli.make_records CONF SRC_PATTERN OUT_DIR
    python -m recommendflow_tpu_torch.cli.make_records CONF --synthetic 10000 --out OUT_DIR
"""
from __future__ import annotations

import argparse

from recommendflow_tpu_torch.config import Configuration
from recommendflow_tpu_torch.utils.tables import print_args


def main(argv=None):
    p = argparse.ArgumentParser(description="Build RFB record files")
    p.add_argument("conf", help="yaml config path")
    p.add_argument("src_pattern", nargs="?", help="source CSV glob")
    p.add_argument("out_dir", nargs="?", help="output directory")
    p.add_argument("--out", dest="out_flag", help="output directory (flag form)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic rows instead of reading CSVs")
    p.add_argument("--num_files", type=int, default=2)
    p.add_argument("--num_procs", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print_args(args)

    conf = Configuration(args.conf)
    out_dir = args.out_flag or args.out_dir
    if args.synthetic and not out_dir and args.src_pattern:
        # `make_records CONF out_dir --synthetic N`: the lone positional
        # binds to src_pattern, which synthetic mode ignores: it is the
        # output directory
        out_dir, args.src_pattern = args.src_pattern, None
    if not out_dir:
        p.error("output directory required (positional or --out)")

    if args.synthetic:
        from recommendflow_tpu_torch.data.synthetic import generate_records
        paths = generate_records(conf, out_dir, num_rows=args.synthetic,
                                 num_files=args.num_files, seed=args.seed)
    else:
        if not args.src_pattern:
            p.error("src_pattern required unless --synthetic is given")
        from recommendflow_tpu_torch.data.writer import build_records
        paths = build_records(args.conf, args.src_pattern, out_dir,
                              num_procs=args.num_procs)
    from recommendflow_tpu_torch.data.recordio import count_rows
    for path in paths:
        print(f"wrote {path}: {count_rows(path)} rows")


if __name__ == "__main__":
    main()
