"""Optimizers for embedding-table training (the counterpart of
`recommendflow_tpu/train/optimizers.py`).

The stacked embedding tables dominate the parameter count, so they take
row-wise Adagrad (one f32 accumulator per stored row, acc [R, 1]) and the
dense towers take Adam (`torch.optim.Adam` over the non-table parameters
only; the trainer updates the tables itself, in place, under no_grad):

  * `split_table_update`: row-wise Adagrad from sparse [N, W] row gradients
    (the trainer's split path), strategies "dense" (scatter_add_rows into a
    zero table, then rowwise_adagrad_update), "sparse_set"
    (sparse_adagrad_apply) and "sparse" (scatter-ADD of the update, plain
    torch: the JAX package has no kernel for it);
  * `rowwise_adagrad_update` (ops/cuda/table_update.py) on a dense table
    gradient: the trainer's table_update="dense" path.

Every update runs in place on the table and its accumulator. The duplicate
sum before the kernels (`segment_row_grads`, ops/cuda/embedding_bag.py)
keeps its unique count on the device, so no step waits on the host for it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from recommendflow_tpu_torch.ops.cuda.embedding_bag import (
    scatter_add_rows, segment_row_grads)
from recommendflow_tpu_torch.ops.cuda.sparse_apply import sparse_adagrad_apply
from recommendflow_tpu_torch.ops.cuda.table_update import (
    rowwise_adagrad_update)

# the Adagrad accumulator seed, shared by every table-update path
ADAGRAD_INIT_ACCUMULATOR = 0.1
STRATEGIES = ("dense", "sparse", "sparse_set")


def default_table_lr(learning_rate: float) -> float:
    """The table LR derived from the dense LR (Adagrad wants a larger one)."""
    return max(learning_rate * 30.0, 0.01)


def init_accumulator(table: torch.Tensor) -> torch.Tensor:
    """A table's row-wise Adagrad accumulator: [R, 1] f32 at the seed."""
    return torch.full((table.shape[0], 1), ADAGRAD_INIT_ACCUMULATOR,
                      dtype=torch.float32, device=table.device)


def split_table_update(p: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                       g: torch.Tensor, *, lr: float, eps: float = 1e-10,
                       strategy: str = "dense"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise Adagrad from sparse per-row gradients, in place.

    p [R, W] (f32 or bf16), acc [R, 1] f32, ids [N] stored rows (duplicates
    allowed, any order), g [N, W] row gradients -> (p, acc), both updated in
    place. Every strategy squares the SUM of a row's duplicate gradients,
    summed in f32.

      "dense":      scatter_add_rows of the sums into a zero [R, W] table of
                    p's dtype (one rounding), then rowwise_adagrad_update
                    over the whole table (rows whose gradient is zero keep
                    their bits). The JAX strategy adds the duplicates into
                    the zero table one by one in p's dtype, rounding after
                    each add: for a bf16 table and a row a batch touches
                    many times the two sums differ by more than a rounding.
      "sparse_set": sparse_adagrad_apply on the unique rows only;
                    untouched rows keep their bits.
      "sparse":     the JAX package's ADD form in plain torch (no kernel):
                    the accumulator and the update, rounded to p's dtype, are
                    added at the unique rows."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown split strategy {strategy!r} "
                         f"(one of {STRATEGIES})")
    s, order = torch.sort(ids.to(torch.int32), stable=True)
    summed, uid, valid, n_valid = segment_row_grads(
        s, g[order].float(), num_rows=p.shape[0])

    if strategy == "dense":
        gd = torch.zeros_like(p)
        scatter_add_rows(uid, summed, gd, n_valid)
        return rowwise_adagrad_update(p, acc, gd, lr=lr, eps=eps)

    if strategy == "sparse_set":
        return sparse_adagrad_apply(p, acc, uid, summed, n_valid, lr=lr,
                                    eps=eps)

    # ADD semantics: padding segments point back IN bounds at the last real
    # row and add zero there
    rows = torch.where(valid, uid, s[-1].to(torch.int32)).long()
    d_acc = torch.where(valid[:, None],
                        (summed * summed).mean(dim=1, keepdim=True), 0.0)
    acc.index_add_(0, rows, d_acc)
    upd = -lr * summed * torch.rsqrt(acc[rows] + eps)
    upd = torch.where(valid[:, None], upd, 0.0)
    p.index_add_(0, rows, upd.to(p.dtype))
    return p, acc
