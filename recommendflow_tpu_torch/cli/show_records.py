"""CLI: inspect record files as parsed batches (the counterpart of
`recommendflow_tpu/cli/show_records.py`): the record schema, the raw rows
of the first block and the encoded batch arrays.

    python -m recommendflow_tpu_torch.cli.show_records CONF PATTERN [--rows 4]
        [--batch_size 8]
"""
from __future__ import annotations

import argparse

import numpy as np

from recommendflow_tpu_torch.config import Configuration
from recommendflow_tpu_torch.data.pipeline import Dataset, resolve_paths
from recommendflow_tpu_torch.data.recordio import iter_blocks, read_schema
from recommendflow_tpu_torch.data.schema import compile_schema
from recommendflow_tpu_torch.utils.tables import print_table


def main(argv=None):
    p = argparse.ArgumentParser(description="Inspect RFB record files")
    p.add_argument("conf", help="yaml config path")
    p.add_argument("pattern", help="record file / glob / directory")
    p.add_argument("--rows", type=int, default=4, help="raw rows to show")
    p.add_argument("--batch_size", type=int, default=8)
    args = p.parse_args(argv)

    conf = Configuration(args.conf)
    files = resolve_paths(args.pattern)
    if not files:
        raise SystemExit(f"no record files match {args.pattern}")
    print(f"{len(files)} file(s); schema of {files[0]}:")
    print_table([[c.name, c.vtype] for c in read_schema(files[0])],
                headers=["column", "vtype"], title="Record schema")

    try:
        nrows, block = next(iter_blocks(files[0]))
    except StopIteration:
        raise SystemExit(f"{files[0]} holds no record blocks")
    rows = []
    for i in range(min(args.rows, nrows)):
        for name, (vals, splits) in block.items():
            cell = list(vals[splits[i]:splits[i + 1]])
            cell = [f"<bytes:{len(v)}>" if isinstance(v, bytes) else v
                    for v in cell]
            rows.append([i, name, str(cell[:8]) + ("…" if len(cell) > 8 else "")])
    print_table(rows, headers=["row", "column", "values"], title="Raw rows")

    schema = compile_schema(conf.features)
    # drop_remainder=False: a file smaller than --batch_size still shows its
    # short encoded batch
    batch = next(iter(Dataset(schema, files, batch_size=args.batch_size,
                              shuffle=False, drop_remainder=False)))
    brows = []
    for k, v in batch.items():
        brows.append([k, "x".join(map(str, v.shape)), str(v.dtype),
                      f"{np.min(v):.4g}", f"{np.max(v):.4g}"])
    print_table(brows, headers=["feature", "shape", "dtype", "min", "max"],
                title=f"Encoded batch (B={args.batch_size})")


if __name__ == "__main__":
    main()
