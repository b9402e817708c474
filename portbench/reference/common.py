"""The plain reference's shared parts, in plain PyTorch: weights made from a
seed (tables whole in one draw, or by fixed blocks of rows for cells on a
mesh), matrix products in float32 (or, for the control, in TF32), pooled
embeddings with their rows as leaves, BatchNorm, dropout drawn from the
device's default generator, Adam and the tables' row-wise Adagrad.

It imports nothing of the program and takes nothing the program made.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.layout import Layout

TABLE_INIT_SCALE = 0.05
_MASK64 = (1 << 64) - 1
# entries of one drawn block of a table (`draw_rows`): 32 MB in bf16
BLOCK_ELEMENTS = 1 << 24

# ------------------------------------------------------------ precision


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest), as a
    tensor core reads an operand when TF32 is on."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Precision:
    """How the reference multiplies: "float32" (TF32 off, the configurations'
    precision) or "tf32" (the control: each operand of every matrix product
    rounded to TF32, products summed in float32)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"precision {name!r}: float32 or tf32")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _TF32MatMul.apply(a, b) if self.name == "tf32" else a @ b

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor]) -> torch.Tensor:
        y = self.mm(x, w.t())
        return y + b if b is not None else y


class _TF32MatMul(torch.autograd.Function):
    """a @ b with every operand rounded to TF32, in the backward too."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products without TF32 on a card, for the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# --------------------------------------------------------------- weights

def seed_generator(seed: int, device: torch.device, salt: int) -> torch.Generator:
    """A generator on `device` for one use of the run's seed (any size of
    whole number: folded to 64 bits)."""
    mixed = splitmix64(((int(seed) & _MASK64) ^ (salt * 0x9E3779B97F4A7C15)) & _MASK64)
    return torch.Generator(device=device).manual_seed(mixed & ((1 << 63) - 1))


def splitmix64(z: int) -> int:
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def make_tables(layout: Layout, seed: int, device: torch.device
                ) -> Dict[int, torch.Tensor]:
    """{dim: [logical rows, dim] table in the tables' dtype}: U[-0.05, 0.05)
    in one call per table, every member table's pad row zero."""
    dtype = getattr(torch, layout.table_dtype)
    gen = seed_generator(seed, device, 1)
    out = {}
    for dim, g in layout.groups.items():
        t = torch.empty((g.logical_rows, dim), dtype=dtype, device=device)
        t.uniform_(-TABLE_INIT_SCALE, TABLE_INIT_SCALE, generator=gen)
        pads = torch.tensor(sorted(g.offsets.values()), device=device)
        t[pads] = 0
        out[dim] = t
    return out


def block_rows(dim: int) -> int:
    """Logical rows in one drawn block of a table of width `dim`."""
    return max(1, BLOCK_ELEMENTS // dim)


def _draw_block(seed: int, dim: int, block: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """Block `block` of the table of width `dim`: [block_rows(dim), dim]
    U[-0.05, 0.05) from its own stream of (seed, dim, block)."""
    gen = seed_generator(seed, device, (4 << 56) | (dim << 32) | block)
    out = torch.empty((block_rows(dim), dim), dtype=dtype, device=device)
    return out.uniform_(-TABLE_INIT_SCALE, TABLE_INIT_SCALE, generator=gen)


def draw_logical_rows(layout: Layout, seed: int, dim: int, ids: torch.Tensor
                      ) -> torch.Tensor:
    """The rows of sorted distinct logical ids [N] of the stacked table of
    width `dim`, in the tables' dtype, drawn by block (`_draw_block`: each
    block that holds one of them drawn once, then dropped), every member
    table's pad row zero: the same rows whether they are drawn alone, in a
    rank's block or with the whole table. Cells on a mesh take their
    tables from here; `make_tables`' one draw a table stays the one-card
    cells'."""
    g = layout.groups[dim]
    dtype = getattr(torch, layout.table_dtype)
    out = torch.empty((len(ids), dim), dtype=dtype, device=ids.device)
    n = block_rows(dim)
    blocks, counts = torch.unique_consecutive(ids // n, return_counts=True)
    at = 0
    for b, c in zip(blocks.tolist(), counts.tolist()):
        block = _draw_block(seed, dim, b, dtype, ids.device)
        out[at:at + c] = block[ids[at:at + c] - b * n]
        at += c
    pads = torch.tensor(sorted(g.offsets.values()), device=ids.device)
    out[torch.isin(ids, pads)] = 0
    return out


def draw_rows(layout: Layout, seed: int, dim: int, start: int, stop: int,
              device: torch.device) -> torch.Tensor:
    """Logical rows [start, stop) of the stacked table of width `dim`
    (`draw_logical_rows`)."""
    return draw_logical_rows(layout, seed, dim,
                             torch.arange(start, stop, device=device))


class TouchedRows:
    """The stored rows of one stacked table that some batches touch, every
    logical row of each (`values` [S*P, dim], drawn by `draw_logical_rows`),
    in the order of their stored ids (`stored` [S], sorted): a table that is
    never held whole. Indexed by global logical ids as the whole table is
    (`pooled_features`); `positions` maps stored ids to rows of
    `values.view(S, P*dim)`, where the row-wise Adagrad updates them."""

    def __init__(self, layout: Layout, seed: int, dim: int,
                 logical_ids: torch.Tensor):
        self.pack = layout.groups[dim].pack
        self.stored = torch.unique(logical_ids.long() // self.pack)
        lanes = torch.arange(self.pack, device=self.stored.device)
        logical = (self.stored[:, None] * self.pack + lanes[None, :]).reshape(-1)
        self.values = draw_logical_rows(layout, seed, dim, logical)

    def positions(self, stored_ids: torch.Tensor) -> torch.Tensor:
        return torch.searchsorted(self.stored, stored_ids.long())

    def __getitem__(self, logical_ids: torch.Tensor) -> torch.Tensor:
        ids = logical_ids.long()
        return self.values[self.positions(ids // self.pack) * self.pack
                           + ids % self.pack]


def table_store(table) -> torch.Tensor:
    """The tensor that holds a table's rows: the whole table, or a
    `TouchedRows`' values."""
    return table.values if isinstance(table, TouchedRows) else table


def store_positions(table, stored_ids: torch.Tensor) -> torch.Tensor:
    """Stored ids -> rows of `table_store(table)` viewed by stored row."""
    return table.positions(stored_ids) if isinstance(table, TouchedRows) \
        else stored_ids


def make_dense(specs: Sequence[Tuple[str, Tuple[int, ...], str]], seed: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Every dense parameter and buffer, float32, from one normal draw:
    weights N(0, 1/fan_in), biases N(0, 0.01^2), BatchNorm scales 1 +
    N(0, 0.1^2), shifts and running means N(0, 0.1^2), running variances
    exp(N(0, 0.2^2)), cross weights N(0, 0.05^2)."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = seed_generator(seed, device, 2)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, start = {}, 0
    for (name, shape, kind), n in zip(specs, sizes):
        x = flat[start:start + n].view(shape)
        start += n
        if kind == "weight":
            x = x / math.sqrt(shape[-1])
        elif kind == "bias":
            x = 0.01 * x
        elif kind == "bn_scale":
            x = 1.0 + 0.1 * x
        elif kind in ("bn_shift", "bn_mean"):
            x = 0.1 * x
        elif kind == "bn_var":
            x = torch.exp(0.2 * x)
        elif kind == "cross_weight":
            x = 0.05 * x
        else:
            raise ValueError(f"unknown parameter kind {kind!r}")
        out[name] = x.contiguous()
    return out


TRAINED_KINDS = ("weight", "bias", "bn_scale", "bn_shift", "cross_weight")


# ------------------------------------------------------------ embeddings

class Rows:
    """The rows of one stacked table that a batch reads: each distinct
    logical row once, as a float32 leaf whose gradient is the row's summed
    gradient."""

    def __init__(self, table: torch.Tensor, gids: torch.Tensor, grad: bool):
        self.uniq, inverse = torch.unique(gids, return_inverse=True)
        self.inverse = inverse
        self.values = table[self.uniq].float()
        if grad:
            self.values.requires_grad_()

    def take(self, start: int, n: int) -> torch.Tensor:
        return self.values[self.inverse[start:start + n]]


def pooled_features(layout: Layout, tables: Mapping[int, torch.Tensor],
                    batch: Mapping[str, torch.Tensor], grad: bool = False
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[int, Rows]]:
    """{feature: [B, width]} (sparse features sum-pooled over their not-pad
    ids, branches side by side; dense features as they are) and the row
    leaves of each table."""
    gids: Dict[int, List[torch.Tensor]] = {}
    for f in layout.sparse():
        g = layout.groups[f["dim"]]
        offs = torch.tensor([g.offsets[(f["name"], h)] for h in range(f["hashes"])],
                            device=batch[f["name"]].device)
        gids.setdefault(f["dim"], []).append(
            (batch[f["name"]].long() + offs[None, :, None]).reshape(-1))
    rows = {d: Rows(tables[d], torch.cat(v), grad) for d, v in gids.items()}
    starts = {d: 0 for d in rows}
    out: Dict[str, torch.Tensor] = {}
    for f in layout.features:
        x = batch[f["name"]]
        if f["kind"] != "sparse":
            out[f["name"]] = x.float().reshape(x.shape[0], -1)
            continue
        d = f["dim"]
        n = x.numel()
        e = rows[d].take(starts[d], n).view(*x.shape, d)        # [B, H, L, d]
        starts[d] += n
        if f["pooling"] != "sum":
            raise ValueError(f"pooling {f['pooling']!r} has no reference here")
        e = (e * (x > 0)[..., None].float()).sum(dim=2)          # [B, H, d]
        out[f["name"]] = e.reshape(x.shape[0], -1)
    return out, rows


def concat(features: Mapping[str, torch.Tensor], names: Iterable[str]) -> torch.Tensor:
    return torch.cat([features[n] for n in names], dim=-1)


# ------------------------------------------------------------- layers

def batch_norm(x: torch.Tensor, p: Mapping[str, torch.Tensor], name: str,
               training: bool, eps: float) -> torch.Tensor:
    """BatchNorm over the batch axis: the batch's mean and biased variance
    in training, the running ones in evaluation."""
    if training:
        mean = x.mean(dim=0)
        var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
    else:
        mean, var = p[f"{name}.mean"], p[f"{name}.var"]
    return (x - mean) * (torch.rsqrt(var + eps) * p[f"{name}.scale"]) \
        + p[f"{name}.shift"]


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        idx = device.index if device.index is not None else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


def dropout_seed(run_seed: int, step: int) -> int:
    """The seed of step `step`'s dropout draws in a run seeded `run_seed`:
    the trainer's recipe (splitmix64's finaliser of seed and step packed in
    one word). The draws themselves are PyTorch's own dropout on the
    device's default generator, in the order of the layers."""
    return splitmix64(((run_seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    return F.dropout(x, p, training=True) if training and p > 0 else x


# ------------------------------------------------------------- updates

class Adam:
    """Adam over named float32 leaves (bias-corrected, eps outside the
    root)."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> None:
        self.t += 1
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g))
            v = self.v.get(k, torch.zeros_like(g))
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            mhat = m / (1 - self.b1 ** self.t)
            denom = torch.sqrt(v) / math.sqrt(1 - self.b2 ** self.t) + self.eps
            params[k] = params[k] - self.lr * mhat / denom


def stored_row_grads(layout: Layout, dim: int, rows: Rows
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A table's logical row gradients -> (distinct stored rows [S], their
    gradients [S, P*dim] float32)."""
    g = layout.groups[dim]
    grad = rows.values.grad
    if grad is None:
        grad = torch.zeros_like(rows.values)
    stored = rows.uniq // g.pack
    seg = rows.uniq % g.pack
    uniq_stored, where = torch.unique(stored, return_inverse=True)
    out = torch.zeros((len(uniq_stored), g.pack, dim), dtype=torch.float32,
                      device=grad.device)
    out[where, seg] = grad
    return uniq_stored, out.view(len(uniq_stored), g.pack * dim)


def rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, pack: int,
                    ids: torch.Tensor, g: torch.Tensor, lr: float,
                    eps: float) -> None:
    """Row-wise Adagrad on distinct stored rows, in place: acc[r] +=
    mean(g[r]^2), p[r] -= lr * g[r] / sqrt(acc[r] + eps), in float32 and
    rounded once to the table's dtype."""
    stored = table.view(-1, table.shape[1] * pack)
    a = acc[ids] + (g * g).mean(dim=1)
    acc[ids] = a
    p = stored[ids].float() - lr * g * torch.rsqrt(a + eps)[:, None]
    stored[ids] = p.to(table.dtype)


# ------------------------------------------------------------- top-k

def exact_scores(queries: torch.Tensor, items: torch.Tensor,
                 precision: Precision, block: int = 1 << 18) -> torch.Tensor:
    """[Q, N] inner products of queries and items, in blocks of items."""
    return torch.cat([precision.mm(queries, items[s:s + block].t())
                      for s in range(0, len(items), block)], dim=1)


def normalize_rows(x: np.ndarray | torch.Tensor):
    if isinstance(x, np.ndarray):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    return l2_normalize(x)
