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

`gather_pooled_bags` is the embed pass's form for a dim group whose slots are
all sum-pooled (ops/embedding.py:embed_batch picks it): the ids are
all-gathered, each rank writes the rows its block owns, in the table's
dtype and zeros elsewhere (`ops/cuda/pooled_lookup.py:gather_owned`), and a
reduce-scatter gives each rank its own examples' rows, exactly (one owner
an id), which it pools as the single table's lookup does, to the same
bits. Only the pooled bags enter autograd: the backward all-gathers their
gradient ([n, bags, dim], not [n, cols, dim]) and sums it into the owned
rows (`pooled_row_grads`). Pooling on the owner before the exchange would
move fewer bytes, but it adds a bag's rows in another order than the
single table's pooling; at DLRM-DCNv2's batch of 65536 those roundings
flip ReLUs in the top MLP and move the dense gradients by up to 5e-5 of
their norms.

Spans (utils/profiling.py:span, recorded under a profiler only):
`shard.lookup` over `gather_local_rows` and `gather_pooled_bags`, counting the
global `ids` looked up, the global batch's `bags` (the pooled form only)
and the `exchange_bytes` its collectives hand NCCL (the all-gather's output
and the all-reduce's or the reduce-scatter's input), and
`shard.lookup_grad` over the backward's exchange (the all-reduce of the
rows' gradients, or the all-gather of the pooled gradient), with its
`exchange_bytes`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

from recommendflow_tpu_torch.config.proto import FeaturePooling
from recommendflow_tpu_torch.data.schema import TableGroup
from recommendflow_tpu_torch.ops.cuda.pooled_lookup import (Bags, gather_owned,
                                                            pooled_row_grads)
from recommendflow_tpu_torch.parallel.distributed import (
    _AllReduceSum, all_gather_nograd, reduce_scatter_nograd)
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


def _pool_rows(rows: torch.Tensor, ids: torch.Tensor, bags: Bags
               ) -> torch.Tensor:
    """This rank's rows [b, cols, dim] f32 and fused ids [b, cols] ->
    [b, bags.count, dim]: each slot pooled as the single table's lookup
    pools it (`pool_sequence` on [b, H, L, dim], pads masked), to the same
    bits."""
    from recommendflow_tpu_torch.ops.embedding import pool_sequence
    out, j = [], 0
    for h in bags.slots or (1,) * bags.count:
        s, n = bags.start[j], bags.length[j]
        e = rows[:, s:s + h * n].reshape(rows.shape[0], h, n, rows.shape[2])
        mask = torch.stack([ids[:, s + k * n:s + (k + 1) * n] > bags.pad[j + k]
                            for k in range(h)], dim=1)
        out.append(pool_sequence(e, mask, FeaturePooling.Sum))
        j += h
    return torch.cat(out, dim=1)


class _PooledBags(torch.autograd.Function):
    """This rank's pooled bags [b, bags, dim] f32 from its block of the
    table and the global batch's ids [W*b, cols]: each rank's owned rows
    reduce-scattered in the table's dtype (exact: one owner an id), then
    pooled. The backward all-gathers the pooled gradient under the
    `shard.lookup_grad` span and sums it into the owned rows of a zero
    block gradient of the table's dtype."""

    @staticmethod
    def forward(ctx, table, everyone, bags, dim, group, rank):
        logical = table.view(-1, dim)
        start = rank * logical.shape[0]
        owned = gather_owned(logical, everyone.view(-1), start)
        rows = reduce_scatter_nograd(owned.view(everyone.shape + (dim,)),
                                     group)
        n = rows.shape[0]
        ctx.save_for_backward(everyone)
        ctx.meta = (table.shape, table.dtype, bags, dim, group, start)
        return _pool_rows(rows.float(), everyone[rank * n:(rank + 1) * n],
                          bags)

    @staticmethod
    def backward(ctx, g):
        everyone, = ctx.saved_tensors
        shape, dtype, bags, dim, group, start = ctx.meta
        with span("shard.lookup_grad") as s:
            g_all = all_gather_nograd(g, group)
            s.add(exchange_bytes=g_all.numel() * g_all.element_size())
        dtable = torch.zeros(shape, dtype=dtype, device=g.device)
        pooled_row_grads(g_all, everyone, bags, start, dtable.view(-1, dim))
        return dtable, None, None, None, None, None


def gather_pooled_bags(table_shard: torch.Tensor, shard: RowShard,
                       group: TableGroup, ids: torch.Tensor, bags: Bags
                       ) -> torch.Tensor:
    """This rank's fused ids [b, cols] (its rows of the global batch; every
    rank passes the same shape) -> [b, bags.count, dim] f32, each bag's
    valid ids' rows summed: the ids are all-gathered, each rank's owned
    rows reduce-scattered to the examples' ranks and pooled there."""
    mesh, axis = shard.mesh, shard.axis
    with span("shard.lookup") as s:
        everyone = all_gather_nograd(ids, mesh.group(axis))
        pooled = _PooledBags.apply(
            table_shard, everyone.to(torch.int32).contiguous(), bags,
            group.dim, mesh.group(axis), mesh.rank(axis))
        s.add(ids=everyone.numel(), bags=everyone.shape[0] * bags.count,
              exchange_bytes=everyone.numel() * (
                  everyone.element_size()
                  + group.dim * table_shard.element_size()))
    return pooled


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
