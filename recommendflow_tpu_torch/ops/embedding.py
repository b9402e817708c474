"""The embedding engine: packed stacked tables + fused lookup/pooling (the
counterpart of `recommendflow_tpu/ops/embedding.py`).

  * All tables of equal dim are stacked row-wise into ONE logical
    [total_rows, dim] array per dim group (schema.TableGroup): one gather per
    group per batch.
  * Tables keep the JAX package's STORED layout [R/P, P*dim] (P logical rows
    per 512-byte physical row), so weights carry across unchanged
    (interop.py). On this card the packed layout is just a row-major reshape
    of [R, dim]: a lookup gathers logical rows of `table.view(-1, dim)` at the
    global ids — bit-identical to the JAX wide-row take followed by the
    one-hot segment select, and 128 bytes read per id instead of 512.
  * The gather is `take_rows`: forward `gather_rows` through its custom op
    (`torch.ops.recflow.gather_rows`, one node of an exported program),
    backward the sorted duplicate sum (`combine_row_grads`,
    ops/cuda/row_grad_combine.py) and `scatter_add_rows` into a zero table
    (ops/cuda/embedding_bag.py).
    Masked pooling stays in torch.
  * The split-update trainer gathers stored rows itself, outside autograd,
    and hands them in under `rows_key(dim)`; `gather_group` then selects each
    id's segment of its wide row, so autograd yields [N, P*dim] row
    gradients and no table gradient.
  * Hashing features own two stacked branches (double hashing); pooled branch
    outputs concatenate to 2*dim.
  * id 0 of every member table is the pad/OOV row, zero-initialized and
    masked out of pooling.
  * An image slot's pixels [B, S, S, 3] are cut into 8x8 patches, projected
    by the slot's `img_{name}` [192, dim] matrix and mean-pooled
    (`patch_embed`); under `Networks.image_encoder: vit` the model's
    `ImageEncoder` takes the slot instead (models/base.py).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from recommendflow_tpu_torch.config.proto import FeaturePooling
from recommendflow_tpu_torch.data.schema import (BatchSchema, FeatureSlot,
                                                 TableGroup)
from recommendflow_tpu_torch.ops.cuda.embedding_bag import (
    gather_rows_op, scatter_add_rows)
from recommendflow_tpu_torch.ops.cuda.pooled_lookup import MAX_BAGS, Bags
from recommendflow_tpu_torch.ops.cuda.row_grad_combine import (
    combine_row_grads)

NEG_INF = -1e9
POS_INF = 1e9
ROW_BYTES = 512        # physical-row packing of the stored layout
SHARD_MULTIPLE = 256   # physical rows padded to a multiple of this
IMAGE_PATCH = 8        # patchify side: [S, S, 3] -> [(S/8)^2, 192] patch rows

DType = Union[str, torch.dtype]


def torch_dtype(dtype: DType) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[str(dtype)]


def pack_factor(dim: int, dtype: DType = torch.float32) -> int:
    """Logical rows per stored row: the minor dim is packed up to 512 bytes
    (128 f32 / 256 bf16 elements) when dim divides that lane count, else 1."""
    lanes = ROW_BYTES // torch.empty((), dtype=torch_dtype(dtype)).element_size()
    if dim < lanes and lanes % dim == 0:
        return lanes // dim
    return 1


def padded_rows(group: TableGroup, dtype: DType = torch.float32) -> int:
    """Logical rows padded so the stored row count is a multiple of
    SHARD_MULTIPLE (the JAX package's sharding rule; kept so the stored
    shapes match)."""
    p = pack_factor(group.dim, dtype)
    phys = -(-group.total_rows // p)
    phys = -(-phys // SHARD_MULTIPLE) * SHARD_MULTIPLE
    return phys * p


def table_shape(group: TableGroup, dtype: DType = torch.float32
                ) -> Tuple[int, int]:
    """Stored (packed) shape of a dim group's stacked table."""
    p = pack_factor(group.dim, dtype)
    return (padded_rows(group, dtype) // p, p * group.dim)


def init_group_table(generator: torch.Generator, group: TableGroup,
                     dtype: DType = torch.float32, scale: float = 0.05,
                     device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """One dim group's stacked table in the stored layout: U[-scale, scale)
    with each member table's pad row zeroed. `generator` must live on
    `device`; its numbers differ from jax.random's for the same seed."""
    dtype = torch_dtype(dtype)
    rows = padded_rows(group, dtype)
    flat = torch.empty((rows, group.dim), dtype=dtype, device=device)
    flat.uniform_(-scale, scale, generator=generator)
    pad_rows_idx = torch.as_tensor(group.offsets, dtype=torch.long,
                                   device=device)
    flat[pad_rows_idx] = 0
    p = pack_factor(group.dim, dtype)
    return flat.view(rows // p, p * group.dim)


def init_group_block(generator: torch.Generator, group: TableGroup,
                     index: int, count: int, dtype: DType = torch.float32,
                     scale: float = 0.05,
                     device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Block `index` of `count` of one dim group's stacked table, in the
    stored layout: its stored rows [index * S, (index + 1) * S), S the
    stored rows over `count` (which must divide them), U[-scale, scale)
    from a generator of the block's own (seeded from `generator`'s seed and
    `index`), each member table's pad row that falls in the block zeroed.
    A rank's block of a row-sharded table made without the whole table:
    its values are not the whole table's draw of those rows."""
    dtype = torch_dtype(dtype)
    stored, width = table_shape(group, dtype)
    if stored % count:
        raise ValueError(f"{stored} stored rows of dim{group.dim} do not "
                         f"split into {count} blocks")
    p = width // group.dim
    rows = stored // count * p
    start = index * rows
    gen = torch.Generator(device=device).manual_seed(
        (generator.initial_seed() * 0x9E3779B1 + index + 1) & ((1 << 63) - 1))
    flat = torch.empty((rows, group.dim), dtype=dtype, device=device)
    flat.uniform_(-scale, scale, generator=gen)
    pads = [o - start for o in group.offsets if start <= o < start + rows]
    if pads:
        flat[torch.as_tensor(pads, dtype=torch.long, device=device)] = 0
    return flat.view(rows // p, width)


class _TakeRows(torch.autograd.Function):
    """rows = table[ids]; the backward sums the gradients of duplicate ids
    (sorted, in f32, fixed size, the unique count kept on the device) and
    scatter-adds them into a zero table with scatter_add_rows, rounding once
    to the table's dtype. The JAX backward adds the duplicates one by one in
    the table's dtype. The host does not check the ids' range here: the
    embed pass's global ids are in range once the host has checked the
    batch (`data/schema.py:check_batch_ids`), so the host never waits here;
    on a card the kernel's device-side assert still stops an id outside the
    table (on the CPU it raises IndexError)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return gather_rows_op(table, ids)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        (summed, uid, _valid, n_valid), = combine_row_grads(
            [(ids.to(torch.int32).contiguous(), g.contiguous(),
              ctx.table_shape[0])])
        dtable = torch.zeros(ctx.table_shape, dtype=ctx.table_dtype,
                             device=g.device)
        scatter_add_rows(uid, summed, dtable, n_valid)
        return dtable, None


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` for table [R, W] and flat int32 ids [N] in [0, R) (no
    host check on a card: see _TakeRows), differentiable in table: its
    gradient is a dense [R, W] table of table's dtype."""
    return _TakeRows.apply(table, ids)


def init_tables(schema: BatchSchema, generator: torch.Generator,
                dtype: Optional[DType] = None, scale: float = 0.05,
                device: Union[str, torch.device] = "cuda"
                ) -> Dict[str, torch.Tensor]:
    """One packed stacked table per dim group ('dim{d}') and a patch
    projection [192, dim] per image slot ('img_{name}', lecun_normal), drawn
    in that order from `generator` (which lives on `device`). dtype
    defaults to the schema's `table_dtype`: the stored shape depends on it
    (the pack factor)."""
    if dtype is None:
        dtype = getattr(schema, "table_dtype", "float32")
    params: Dict[str, torch.Tensor] = {}
    for dim, group in schema.groups.items():
        params[f"dim{dim}"] = init_group_table(generator, group, dtype, scale,
                                               device=device)
    for name in schema.order:
        slot = schema.slots[name]
        if slot.kind == "image":
            fan_in = IMAGE_PATCH * IMAGE_PATCH * 3
            proj = torch.empty((fan_in, slot.dim), device=device)
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            torch.nn.init.trunc_normal_(proj, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
            params[f"img_{name}"] = proj
    return params


def patchify(images: torch.Tensor, patch: int = IMAGE_PATCH) -> torch.Tensor:
    """[B, S, S, C] pixels -> [B, (S/p)^2, p*p*C] patch rows (row-major
    patches, each flattened row by row as the JAX reshape does)."""
    b, s, _, c = images.shape
    n = s // patch
    x = images.reshape(b, n, patch, n, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, n * n, patch * patch * c)


def patch_embed(proj: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """[B, S, S, 3] pixels -> [B, dim]: 8x8 patches times `proj`
    [192, dim], mean over the patches. One f32 matmul in torch, as the JAX
    package computes it outside any Pallas kernel."""
    return torch.matmul(patchify(images), proj).mean(dim=1)


def gather_group(table: torch.Tensor, group: TableGroup,
                 global_ids: torch.Tensor,
                 wide_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather logical rows from a stored stacked table.

    table: [rows/P, P*dim] (P read from the stored shape); global_ids: any int
    shape -> [..., dim] f32, cast after the gather so compute downstream is
    full precision.

    A table that `parallel.sharded_embedding.mark_row_shard` marked (this
    rank's block of a row-sharded table) takes this rank's ids of a global
    batch: `gather_local_rows` looks them up across the ranks.

    wide_rows: pre-gathered stored rows [N, P*dim] (N = global_ids.numel()),
    the split-update path's rows: their values must equal the stored rows
    `physical_ids(...)` names. Each id's segment is selected from its wide
    row, so the gradient lands on wide_rows and none on the table."""
    dim = group.dim
    shard = getattr(table, "row_shard", None)
    if shard is not None and wide_rows is None:
        from recommendflow_tpu_torch.parallel.sharded_embedding import (
            gather_local_rows)
        return gather_local_rows(table, shard, group, global_ids)
    flat = global_ids.reshape(-1).to(torch.int32).contiguous()
    if wide_rows is None:
        rows = take_rows(table.view(-1, dim), flat)
    else:
        n, width = flat.shape[0], table.shape[1]
        if tuple(wide_rows.shape) != (n, width):
            raise ValueError(
                f"wide_rows shape {tuple(wide_rows.shape)} does not match the "
                f"fused id layout ({n}, {width}): the model's embed pass "
                f"differs from the trainer's fused_group_ids plan")
        p = width // dim
        seg = (flat.long() % p).view(n, 1, 1).expand(n, 1, dim)
        rows = wide_rows.view(n, p, dim).gather(1, seg).view(n, dim)
    return rows.view(tuple(global_ids.shape) + (dim,)).float()


def rows_key(dim: int) -> str:
    """Reserved batch key carrying pre-gathered stored rows for a dim group
    (split-update path)."""
    return f"__rows_dim{dim}__"


@functools.lru_cache(maxsize=None)
def _cached_offsets(offsets: Tuple[int, ...], dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    return torch.as_tensor(offsets, dtype=dtype, device=device)


def _offsets_on(offsets: Tuple[int, ...], dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """A slot's branch offsets as a tensor on `device`, copied once: a copy
    from pageable host memory makes the host wait for the card's queue.
    While `torch.export` traces, a fresh tensor (a constant of the traced
    program): the tracer's fake tensor must not enter the cache."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return torch.as_tensor(offsets, dtype=dtype, device=device)
    return _cached_offsets(offsets, dtype, device)


def _global_ids(schema: BatchSchema, slot: FeatureSlot,
                ids: torch.Tensor) -> torch.Tensor:
    group = schema.groups[slot.dim]
    offs = _offsets_on(tuple(group.offset_of(slot.name, h)
                             for h in range(slot.num_hashes)),
                       ids.dtype, ids.device)
    return ids + offs[None, :, None]


def _fused_ids(schema: BatchSchema, group_slots, batch):
    """The fused id layout embed_batch gathers with: per-slot global ids
    flattened to [B, H*L] and concatenated."""
    gids = [_global_ids(schema, s, batch[s.name]).reshape(
        batch[s.name].shape[0], -1) for s in group_slots]     # [B, H*L]
    return [g.shape[1] for g in gids], torch.cat(gids, dim=1)


def _sparse_by_dim(slots: Sequence[FeatureSlot], exclude: Sequence[str] = ()
                   ) -> Dict[int, List[FeatureSlot]]:
    by_dim: Dict[int, List[FeatureSlot]] = {}
    for slot in slots:
        if slot.name not in exclude and slot.kind == "sparse":
            by_dim.setdefault(slot.dim, []).append(slot)
    return by_dim


def _slots(schema: BatchSchema, tower: Optional[str]) -> List[FeatureSlot]:
    return schema.tower_slots(tower) if tower else \
        [schema.slots[n] for n in schema.order]


def fused_group_ids(schema: BatchSchema, batch: Dict[str, torch.Tensor],
                    tower: Optional[str] = None,
                    exclude: Sequence[str] = ()) -> Dict[int, torch.Tensor]:
    """{dim: fused global ids [B, sum(H*L)]} for every sparse dim group."""
    return {dim: _fused_ids(schema, group_slots, batch)[1]
            for dim, group_slots in
            _sparse_by_dim(_slots(schema, tower), exclude).items()}


def physical_ids(table: torch.Tensor, dim: int,
                 fused: torch.Tensor) -> torch.Tensor:
    """Flat stored-row indices for a fused global-id array."""
    p = table.shape[1] // dim
    flat = fused.reshape(-1)
    return flat // p if p > 1 else flat


def pool_sequence(emb: torch.Tensor, mask: torch.Tensor,
                  pooling: FeaturePooling) -> torch.Tensor:
    """Masked combine over the length axis.

    emb: [..., L, D]; mask: [..., L] bool. Returns [..., D] (or [..., L, D]
    for Null)."""
    m = mask[..., None].to(emb.dtype)
    if pooling == FeaturePooling.Null:
        return emb * m
    if pooling == FeaturePooling.Cls:
        return emb[..., 0, :] * m[..., 0, :]
    any_valid = mask.any(dim=-1)[..., None].to(emb.dtype)
    if pooling == FeaturePooling.First:
        # first VALID position: lookup/hashing misses leave pad holes in
        # place, so an OOV at position 0 must not zero a later valid value
        idx = mask.to(torch.int8).argmax(dim=-1)
        out = torch.gather(emb, -2, idx[..., None, None].expand(
            emb.shape[:-2] + (1, emb.shape[-1])))
        return out[..., 0, :] * any_valid
    if pooling == FeaturePooling.Last:
        pos = torch.arange(emb.shape[-2], device=emb.device)
        idx = torch.where(mask, pos, torch.zeros_like(pos)).amax(dim=-1)
        out = torch.gather(emb, -2, idx[..., None, None].expand(
            emb.shape[:-2] + (1, emb.shape[-1])))
        return out[..., 0, :] * any_valid
    if pooling == FeaturePooling.Sum:
        return torch.sum(emb * m, dim=-2)
    if pooling == FeaturePooling.Avg:
        denom = torch.clamp(m.sum(dim=-2), min=1.0)
        return torch.sum(emb * m, dim=-2) / denom
    if pooling == FeaturePooling.Max:
        return torch.where(mask[..., None], emb,
                           torch.full_like(emb, NEG_INF)).amax(dim=-2) * any_valid
    if pooling == FeaturePooling.Min:
        return torch.where(mask[..., None], emb,
                           torch.full_like(emb, POS_INF)).amin(dim=-2) * any_valid
    raise ValueError(f"unsupported pooling {pooling}")


def lookup_feature(params: Dict[str, torch.Tensor], schema: BatchSchema,
                   slot: FeatureSlot, ids: torch.Tensor) -> torch.Tensor:
    """One feature: ids [B, H, L] -> pooled [B, H*dim]."""
    group = schema.groups[slot.dim]
    emb = gather_group(params[f"dim{slot.dim}"], group,
                       _global_ids(schema, slot, ids))      # [B, H, L, dim]
    pooled = pool_sequence(emb, ids > 0, slot.pooling)
    return pooled.reshape(pooled.shape[0], -1)


def _sum_bags(group: TableGroup, group_slots: Sequence[FeatureSlot]):
    """The bags of a dim group's fused ids (one a slot and hash branch, in
    the fused layout's order) when every slot is sum-pooled and they fit
    one kernel call; else None."""
    if any(s.pooling != FeaturePooling.Sum for s in group_slots):
        return None
    start, length, pad = [], [], []
    col = 0
    for s in group_slots:
        for h in range(s.num_hashes):
            start.append(col)
            length.append(s.max_len)
            pad.append(group.offset_of(s.name, h))
            col += s.max_len
    if len(start) > MAX_BAGS:
        return None
    return Bags(tuple(start), tuple(length), tuple(pad),
                tuple(s.num_hashes for s in group_slots))


def embed_batch(params: Dict[str, torch.Tensor], schema: BatchSchema,
                batch: Dict[str, torch.Tensor],
                tower: Optional[str] = None,
                exclude: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """All sparse features of a batch (optionally one tower) -> pooled dict.

    Features sharing a dim group are gathered in ONE fused gather per group
    (ids concatenated along a flat axis, results split back). `params` maps
    'dim{d}' to the stored tables and 'img_{name}' to an image slot's patch
    projection. Token and bert sequences are left to the text encoders that
    own them, as in the JAX package, and so is an image slot without a
    projection (a ViT image encoder owns it). `exclude` skips slots the
    model embeds itself (Pdm's attention-pooled sequences).

    A group on a table row-sharded over several ranks (`mark_row_shard`)
    whose slots are all sum-pooled takes
    `parallel.sharded_embedding.gather_pooled_bags`, whose backward
    exchanges pooled gradients: each slot's output is a split of the pooled
    bags, so the backward is one concatenation. A mesh axis of one keeps
    the unpooled lookup (`gather_local_rows`), whose table gradient is the
    single table's to the bit, so that a world of one checks the mesh step
    against the single card's; the pooled backward adds each row's terms
    in another grouping, which three Dssm steps on an H100 carry to 2.2e-6
    of a leaf's size."""
    out: Dict[str, torch.Tensor] = {}
    slots = _slots(schema, tower)
    for slot in slots:
        if slot.name in exclude:
            continue
        if slot.kind in ("dense", "embedding"):
            out[slot.name] = batch[slot.name].float()
        elif slot.kind == "image" and f"img_{slot.name}" in params:
            out[slot.name] = patch_embed(params[f"img_{slot.name}"],
                                         batch[slot.name].float())

    for dim, group_slots in _sparse_by_dim(slots, exclude).items():
        group = schema.groups[dim]
        sizes, fused = _fused_ids(schema, group_slots, batch)  # [B, sum(HL)]
        table, wide = params[f"dim{dim}"], batch.get(rows_key(dim))
        shard = getattr(table, "row_shard", None)
        bags = _sum_bags(group, group_slots) if wide is None and \
            shard is not None and shard.mesh.size(shard.axis) > 1 else None
        if bags is not None:
            from recommendflow_tpu_torch.parallel.sharded_embedding import (
                gather_pooled_bags)
            pooled = gather_pooled_bags(table, shard, group, fused,
                                        bags)              # [B, bags, dim]
            parts = torch.split(pooled, [s.num_hashes for s in group_slots],
                                dim=1)
            for s, part in zip(group_slots, parts):
                out[s.name] = part.reshape(part.shape[0], -1)
            continue
        emb = gather_group(table, group, fused,  # [B, sum, dim]
                           wide_rows=wide)
        offset = 0
        for s, size in zip(group_slots, sizes):
            ids = batch[s.name]
            e = emb[:, offset:offset + size, :].reshape(
                ids.shape[0], s.num_hashes, s.max_len, dim)
            offset += size
            pooled = pool_sequence(e, ids > 0, s.pooling)
            out[s.name] = pooled.reshape(ids.shape[0], -1)
    return out


def concat_tower(features: Dict[str, torch.Tensor], schema: BatchSchema,
                 tower: str) -> torch.Tensor:
    """Deterministic-order concat of a tower's pooled features -> [B, D]."""
    parts = [features[s.name] for s in schema.tower_slots(tower)
             if s.name in features]
    return torch.cat(parts, dim=-1)


def touched_stored_rows(schema: BatchSchema, params: Dict[str, torch.Tensor],
                        batch: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """'dim{d}' -> SORTED stored-row ids this batch touches (the id math of
    embed_batch's fused gather, divided by the packing factor read from the
    stored shape). Duplicates are kept."""
    out: Dict[str, torch.Tensor] = {}
    for dim, group_slots in _sparse_by_dim(_slots(schema, None)).items():
        key = f"dim{dim}"
        if key not in params:
            continue
        p = params[key].shape[1] // dim
        flat = torch.cat([_global_ids(schema, s, batch[s.name]).reshape(-1)
                          for s in group_slots])
        out[key] = torch.sort(flat // p if p > 1 else flat).values
    return out
