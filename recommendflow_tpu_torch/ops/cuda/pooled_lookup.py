"""The row-sharded lookup's kernels for sum-pooled bags
(`csrc/pooled_lookup.cu`), which `parallel/sharded_embedding.py:
gather_pooled_bags` runs on each rank:

  * `gather_owned(table, ids, start)`: this rank's block of logical rows
    `table [rows, dim]` (any dtype) and the global batch's ids `[n]` int32
    -> `[n, dim]` in the table's dtype, each id's row where the rank owns it
    (start <= id < start + rows), zeros elsewhere: the input of the ranks'
    reduce-scatter, which gives each rank its own examples' rows exactly;
  * `pooled_row_grads(g, ids, bags, start, grad)`: the transpose of the
    pooling and the exchange, from the pooled gradient `g [n, n_bags, dim]`
    f32 of the global batch's fused ids `[n, cols]`: each block row that an
    owned valid id names gets the f32 sum of its bags' gradients (once per
    occurrence, each rounded to `grad`'s dtype first, as the unpooled
    gather's cast rounds each id's gradient), rounded once to `grad`'s dtype
    and written into `grad [rows, dim]`; no other row is touched (the
    caller zero-fills it).

Replaces no TPU kernel (the JAX package all-reduces unpooled f32 rows). The
plain versions run for CPU tensors only; for CUDA tensors each wrapper
launches the kernels or raises. The backward's sums add in a fixed order
(no float atomics): the same inputs give the same bits.
`gather_owned.launches` and `pooled_row_grads.launches` count calls (the
backward's is a handful of kernels: keys, CUB's radix sort, sums, fix-up).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from recommendflow_tpu_torch.ops.cuda import _build
from recommendflow_tpu_torch.ops.cuda.embedding_bag import (_word_bytes,
                                                            check_cuda,
                                                            vec8_ok)

_NAME = "pooled_lookup"
MAX_BAGS = 256       # csrc/pooled_lookup.cu's kMaxBags
SPAN = 256           # sorted positions a warp sums (kSpan)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class Bags:
    """The bags of a fused id layout [n, cols]: bag j holds columns
    [start[j], start[j] + length[j]), and its ids at or below pad[j] (its
    table's pad row: a slot's local id 0 or below) are masked. The bags
    tile the columns in order; `slots` counts the consecutive bags of each
    slot (its hash branches, of one length), one each when empty."""
    start: Tuple[int, ...]
    length: Tuple[int, ...]
    pad: Tuple[int, ...]
    slots: Tuple[int, ...] = ()

    @property
    def count(self) -> int:
        return len(self.start)

    @property
    def cols(self) -> int:
        return self.start[-1] + self.length[-1]

    def columns(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each column's bag index and pad id (the plain versions')."""
        bag = torch.repeat_interleave(torch.arange(self.count),
                                      torch.tensor(self.length))
        return bag.to(device), torch.tensor(self.pad)[bag].to(device)

    def desc(self):
        """The kernels' descriptor: (start, length, pad) a bag, int32."""
        flat = [v for j in range(self.count)
                for v in (self.start[j], self.length[j], self.pad[j])]
        return (ctypes.c_int32 * len(flat))(*flat)


def gather_owned_plain(table: torch.Tensor, ids: torch.Tensor,
                       start: int) -> torch.Tensor:
    """The plain version: the owned rows gathered, the rest zeros."""
    local = ids.long() - start
    mine = (local >= 0) & (local < table.shape[0])
    got = table[torch.where(mine, local, 0)]
    return torch.where(mine[:, None], got, torch.zeros((), dtype=table.dtype))


def pooled_row_grads_plain(g: torch.Tensor, ids: torch.Tensor, bags: Bags,
                           start: int, grad: torch.Tensor) -> torch.Tensor:
    """The plain version: each owned valid id's bag gradient rounded to the
    block's dtype, summed in f32 per block row in batch order, written
    rounded to the touched rows."""
    rows, dim = grad.shape
    bag, pad = bags.columns(ids.device)
    local = ids.long() - start
    keep = (ids > pad) & (local >= 0) & (local < rows)
    example = torch.arange(ids.shape[0], device=ids.device)[:, None]
    src = g[example.expand_as(ids)[keep], bag.expand_as(ids)[keep]]
    at = local[keep]
    summed = torch.zeros((rows, dim), dtype=torch.float32, device=g.device
                         ).index_add_(0, at, src.to(grad.dtype).float())
    grad[at] = summed[at].to(grad.dtype)
    return grad


def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    if not getattr(lib, "_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rf_gather_owned.argtypes = [p, i64, i64, p, i64, i32, i32, p, p]
        lib.rf_gather_owned.restype = i32
        lib.rf_pooled_grad_temp_bytes.argtypes = [i64, i32,
                                                  ctypes.POINTER(i64)]
        lib.rf_pooled_grad_temp_bytes.restype = i32
        lib.rf_pooled_grad.argtypes = [p, p, i64, i32, p, i32, i64, i32, i64,
                                       i32, p, i32, i32, p, p, p, p, p, i64,
                                       p, p]
        lib.rf_pooled_grad.restype = i32
        lib._typed = True
    return lib


def launch_gather_owned(table: torch.Tensor, ids: torch.Tensor,
                        start: int) -> torch.Tensor:
    """Launch the gather on CUDA tensors; raises on anything it does not
    take, before the launch."""
    dev = check_cuda("gather_owned", table, ids)
    if table.dim() != 2 or not table.is_contiguous() \
            or table.element_size() < 2:
        raise ValueError(f"gather_owned: the block must be a contiguous "
                         f"[rows, dim] of 2- or 4-byte elements, got "
                         f"{table.dtype} {tuple(table.shape)}")
    if ids.dim() != 1 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError(f"gather_owned: ids must be a contiguous int32 "
                         f"vector, got {ids.dtype} {tuple(ids.shape)}")
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=dev)
    if ids.shape[0] == 0:
        return out
    row_bytes = table.shape[1] * table.element_size()
    lib = _lib()
    rc = lib.rf_gather_owned(
        table.data_ptr(), table.shape[0], start, ids.data_ptr(), ids.shape[0],
        row_bytes, _word_bytes(row_bytes, table.data_ptr(), out.data_ptr()),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "gather_owned")
    gather_owned.launches += 1
    return out


def launch_pooled_row_grads(g: torch.Tensor, ids: torch.Tensor, bags: Bags,
                            start: int, grad: torch.Tensor) -> torch.Tensor:
    """Launch the backward's pipeline on CUDA tensors; raises on anything
    it does not take, before any launch."""
    dev = check_cuda("pooled_row_grads", g, ids, grad)
    if grad.dim() != 2 or grad.dtype not in _DTYPES \
            or not grad.is_contiguous():
        raise ValueError(f"pooled_row_grads: grad must be a contiguous "
                         f"f32 or bf16 [rows, dim], got {grad.dtype} "
                         f"{tuple(grad.shape)}")
    if ids.dim() != 2 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError(f"pooled_row_grads: ids must be a contiguous "
                         f"int32 [n, cols], got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if not 0 < bags.count <= MAX_BAGS or bags.cols != ids.shape[1] or any(
            bags.start[j] + bags.length[j] != bags.start[j + 1]
            for j in range(bags.count - 1)) or bags.start[0] != 0:
        raise ValueError(f"pooled_row_grads: {bags.count} bags must tile "
                         f"the {ids.shape[1]} columns, at most {MAX_BAGS}")
    n = ids.shape[0]
    if n * ids.shape[1] >= 2 ** 31 or n * bags.count >= 2 ** 31 \
            or not 0 < grad.shape[0] < 2 ** 31 or start < 0:
        raise ValueError(f"pooled_row_grads: {n} x {ids.shape[1]} ids, "
                         f"{n} x {bags.count} bags and {grad.shape[0]} rows "
                         f"must each stay below 2^31")
    rows, dim = grad.shape
    if tuple(g.shape) != (n, bags.count, dim) or g.dtype != torch.float32 \
            or not g.is_contiguous():
        raise ValueError(f"pooled_row_grads: g must be a contiguous f32 "
                         f"[{n}, {bags.count}, {dim}], got {g.dtype} "
                         f"{tuple(g.shape)}")
    lib = _lib()
    total = n * ids.shape[1]
    end_bit = rows.bit_length()
    temp = ctypes.c_int64(0)
    _build.check(lib, lib.rf_pooled_grad_temp_bytes(total, end_bit,
                                                    ctypes.byref(temp)),
                 "pooled_row_grads (sort scratch)")
    keys_in, keys_out, pay_in, pay_out = (
        torch.empty(total, dtype=torch.int32, device=dev) for _ in range(4))
    scratch = torch.empty(max(temp.value, 1), dtype=torch.uint8, device=dev)
    carry = torch.empty((-(-total // SPAN), dim), dtype=torch.float32,
                        device=dev)
    rc = lib.rf_pooled_grad(
        g.data_ptr(), ids.data_ptr(), n, ids.shape[1], bags.desc(),
        bags.count, rows, dim, start, end_bit, grad.data_ptr(),
        _DTYPES[grad.dtype], int(vec8_ok(dim, g, grad)), keys_in.data_ptr(),
        keys_out.data_ptr(), pay_in.data_ptr(), pay_out.data_ptr(),
        scratch.data_ptr(), scratch.numel(), carry.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "pooled_row_grads")
    pooled_row_grads.launches += 1
    return grad


def gather_owned(table: torch.Tensor, ids: torch.Tensor,
                 start: int) -> torch.Tensor:
    """[n, dim]: each id's row where this rank owns it, zeros elsewhere
    (module docstring)."""
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return gather_owned_plain(table, ids, start)
    return launch_gather_owned(table, ids, start)


def pooled_row_grads(g: torch.Tensor, ids: torch.Tensor, bags: Bags,
                     start: int, grad: torch.Tensor) -> torch.Tensor:
    """Write each touched block row's summed bag gradient into `grad`
    (module docstring); returns grad."""
    if all(t.device.type == "cpu" for t in (g, ids, grad)):
        return pooled_row_grads_plain(g, ids, bags, start, grad)
    return launch_pooled_row_grads(g, ids, bags, start, grad)


gather_owned.launches = 0
pooled_row_grads.launches = 0
