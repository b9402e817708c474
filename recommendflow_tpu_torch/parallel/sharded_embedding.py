"""Row-sharded embedding lookup with explicit collectives (the counterpart
of `recommendflow_tpu/parallel/sharded_embedding.py`).

  * a stacked table is row-sharded over a mesh axis: rank k holds stored
    rows [k*S, (k+1)*S) of the packed stack (`shard_tables`);
  * every rank receives the full id batch, gathers the ids that fall in its
    block through kernel 1 (`take_rows`: gather_rows), foreign ids masked
    to a zero row, and an all-reduce sum assembles the complete embeddings
    (each id belongs to exactly one shard, so the sum IS the lookup);
  * a packed bf16 table is gathered by logical row, so the sub-row is
    selected before the collective: it moves N * dim floats, not N * P *
    dim;
  * the backward is the transpose: the all-reduce sums every rank's
    gradient, the masked gather's backward (the sorted duplicate sum and
    kernel 2, `scatter_add_rows`) lands each row's gradient on its owner's
    block only.

`gather_local_rows` is the embed pass's form: each rank passes its own rows
of the batch, the ids are all-gathered first and each rank keeps its own
slice of the result (ops/embedding.py:gather_group calls it for a table
that `shard_tables` marked).

Spans (utils/profiling.py:span, recorded under a profiler only):
`shard.lookup` over `gather_local_rows`, counting the global `ids` looked
up and the `exchange_bytes` its collectives hand NCCL (the all-gather's
output and the all-reduce's buffer), and `shard.lookup_grad` over the
backward's all-reduce of the rows' gradients, with its `exchange_bytes`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

from recommendflow_tpu_torch.data.schema import TableGroup
from recommendflow_tpu_torch.parallel.distributed import (_AllReduceSum,
                                                          all_gather_nograd)
from recommendflow_tpu_torch.parallel.mesh import Mesh, is_table_param
from recommendflow_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class RowShard:
    """The mark of a parameter whose leading axis is sharded over a mesh
    axis (a table's stored rows, or Mmoe's experts): the axis and the
    leading size of the whole parameter."""
    mesh: Mesh
    axis: str
    total_rows: int

    @property
    def rows(self) -> int:
        return self.total_rows // self.mesh.size(self.axis)

    @property
    def start(self) -> int:
        return self.mesh.rank(self.axis) * self.rows


def local_gather_psum(table_shard: torch.Tensor, flat_ids: torch.Tensor,
                      dim: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """Per-rank body: table_shard [S, P*dim] (this rank's block of stored
    rows), flat_ids [N] GLOBAL logical ids, the same on every rank ->
    [N, dim] f32 rows, each id's row from its owner."""
    logical = table_shard.view(-1, dim)              # [S*P, dim]
    s = logical.shape[0]
    local = flat_ids.long() - mesh.rank(axis) * s
    mine = (local >= 0) & (local < s)
    safe = torch.where(mine, local, torch.zeros_like(local)).to(torch.int32)
    from recommendflow_tpu_torch.ops.embedding import take_rows
    rows = take_rows(logical, safe.contiguous())
    rows = rows.float() * mine[:, None].float()
    return _RowsSum.apply(rows, mesh.group(axis))


class _RowsSum(_AllReduceSum):
    """`all_reduce_sum` of the looked-up rows, its backward (the all-reduce
    of their gradients) under the `shard.lookup_grad` span."""

    @staticmethod
    def backward(ctx, g):
        with span("shard.lookup_grad") as s:
            s.add(exchange_bytes=g.numel() * g.element_size())
            return _AllReduceSum.backward(ctx, g)


def sharded_gather_group(mesh: Mesh, axis: str, table_shard: torch.Tensor,
                         group: TableGroup, global_ids: torch.Tensor
                         ) -> torch.Tensor:
    """gather_group over a row-sharded packed table: global ids (the same
    on every rank) [...] -> [..., dim] f32, whatever the table's storage
    dtype."""
    flat = global_ids.reshape(-1)
    rows = local_gather_psum(table_shard, flat, group.dim, mesh, axis)
    return rows.view(tuple(global_ids.shape) + (group.dim,))


def gather_local_rows(table_shard: torch.Tensor, shard: RowShard,
                      group: TableGroup, ids: torch.Tensor) -> torch.Tensor:
    """This rank's ids [b, ...] (its rows of the global batch; every rank
    passes the same shape) -> [b, ..., dim] f32: the ids are all-gathered,
    looked up by `local_gather_psum` and this rank's slice is kept."""
    mesh, axis = shard.mesh, shard.axis
    flat = ids.reshape(-1)
    with span("shard.lookup") as s:
        everyone = all_gather_nograd(flat, mesh.group(axis))
        rows = local_gather_psum(table_shard, everyone, group.dim, mesh, axis)
        s.add(ids=everyone.numel(),
              exchange_bytes=everyone.numel() * everyone.element_size()
              + rows.numel() * rows.element_size())
    n, r = flat.shape[0], mesh.rank(axis)
    return rows[r * n:(r + 1) * n].view(tuple(ids.shape) + (group.dim,))


def shard_tables(params: Mapping[str, torch.Tensor], mesh: Mesh,
                 axis: str = "dp") -> Dict[str, torch.Tensor]:
    """Each stacked table ('dim{d}' / 'table_dim{d}') whose stored rows the
    axis divides -> this rank's block (a copy); every other leaf (the
    'img_{name}' patch projections) stays whole."""
    n = mesh.size(axis)
    out = {}
    for name, t in params.items():
        t = t.to(mesh.device)
        if t.dim() == 2 and is_table_param(name) and t.shape[0] % n == 0:
            s = t.shape[0] // n
            r = mesh.rank(axis)
            out[name] = t[r * s:(r + 1) * s].clone()
        else:
            out[name] = t
    return out


def mark_row_shard(param: torch.nn.Parameter, mesh: Mesh, axis: str) -> None:
    """Replace a whole parameter's data with this rank's block of its
    leading axis, in place (the optimizer keeps its reference), and mark it:
    a marked table is gathered by the embed pass through
    `gather_local_rows`, marked experts by ops/mlp.py:ExpertsMLP. A
    parameter built at this rank's block alone (its `whole_rows` the
    whole's leading size, as `FeatureEmbedder(mesh=)` makes a table) keeps
    its data."""
    total = getattr(param, "whole_rows", param.shape[0])
    n = mesh.size(axis)
    if total % n:
        raise ValueError(f"{total} stored rows do not split over {n} ranks")
    s = total // n
    r = mesh.rank(axis)
    if param.shape[0] == total:
        with torch.no_grad():
            param.data = param.data[r * s:(r + 1) * s].clone()
    elif param.shape[0] != s:
        raise ValueError(f"{param.shape[0]} rows are neither the whole "
                         f"{total} nor a block of {s} over {n} ranks")
    param.row_shard = RowShard(mesh, axis, total)


def gather_like(owner: Optional[torch.Tensor],
                t: torch.Tensor) -> torch.Tensor:
    """`t` holds the same rows as `owner`'s block (an accumulator, an Adam
    moment): gathered from every rank of the owner's axis (a collective)
    when the owner is marked; else `t` as it is."""
    shard = getattr(owner, "row_shard", None)
    if shard is None:
        return t
    return all_gather_nograd(t.detach(), shard.mesh.group(shard.axis))


def full_rows(t: torch.Tensor) -> torch.Tensor:
    """A marked parameter's whole rows, gathered from every rank (a
    collective); any other tensor as it is."""
    return gather_like(t, t)


def own_rows(owner: Optional[torch.Tensor],
             whole: torch.Tensor) -> torch.Tensor:
    """`whole` (the whole of a marked parameter, or of a tensor with one
    row per row of it) cut to the block `owner` holds when `owner` is
    marked; else `whole`."""
    shard = getattr(owner, "row_shard", None)
    if shard is None:
        return whole
    return whole[shard.start:shard.start + shard.rows]
