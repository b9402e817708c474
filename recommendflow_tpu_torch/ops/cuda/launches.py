"""The kernels' launch counts, read and added to as one record.

Each wrapper in `ops/cuda/` counts its launches where it launches
(`<wrapper>.launches`, and the per-width, per-dtype and per-table-count
dicts of gather_rows, grouped_score_max and combine_row_grads, whose
grouped call counts once). A CUDA graph replay (`train/graphs.py`) calls
no wrapper, so the graph takes a snapshot before and after its capture,
keeps the difference as what one replay launches, takes the capture's own
counts back (a capture launches nothing on the card) and adds the
difference at every replay.
"""
from __future__ import annotations

from typing import Dict

from recommendflow_tpu_torch.ops.cuda import (embedding_bag, flash_attention,
                                              grouped_topk, row_grad_combine,
                                              sparse_apply, table_update)

COUNTERS = {"gather_rows": embedding_bag.gather_rows,
            "scatter_add_rows": embedding_bag.scatter_add_rows,
            "sparse_adagrad_apply": sparse_apply.sparse_adagrad_apply,
            "rowwise_adagrad_update": table_update.rowwise_adagrad_update,
            "flash_attention": flash_attention.flash_attention,
            "grouped_score_max": grouped_topk.grouped_score_max,
            "combine_row_grads": row_grad_combine.combine_row_grads}
# the per-key dicts beside the totals
_BY_KEY = {"gather_rows_by_row_bytes":
           embedding_bag.gather_rows.launches_by_row_bytes,
           "grouped_score_max_by_dtype":
           grouped_topk.grouped_score_max.launches_by_dtype,
           "combine_row_grads_by_tables":
           row_grad_combine.combine_row_grads.launches_by_tables}

Counts = Dict[str, object]


def snapshot() -> Counts:
    """Every counter's value now: {name: int} and {dict name: {key: int}}."""
    return {**{name: fn.launches for name, fn in COUNTERS.items()},
            **{name: dict(d) for name, d in _BY_KEY.items()}}


def difference(after: Counts, before: Counts) -> Counts:
    """What was launched between two snapshots."""
    out: Counts = {}
    for name, v in after.items():
        if isinstance(v, dict):
            was = before.get(name, {})
            out[name] = {k: n - was.get(k, 0) for k, n in v.items()
                         if n != was.get(k, 0)}
        else:
            out[name] = v - before.get(name, 0)
    return out


def add(delta: Counts, times: int = 1) -> None:
    """Add `times` x `delta` to the counters (a negative `times` takes a
    capture's counts back)."""
    for name, v in delta.items():
        if isinstance(v, dict):
            d = _BY_KEY[name]
            for k, n in v.items():
                d[k] = d.get(k, 0) + times * n
        else:
            COUNTERS[name].launches += times * v


def total(delta: Counts) -> int:
    """The launches of every kernel in `delta`."""
    return sum(v for v in delta.values() if not isinstance(v, dict))
