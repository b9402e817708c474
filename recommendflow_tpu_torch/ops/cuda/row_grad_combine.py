"""`combine_row_grads`: the split table update's duplicate-combining stage
(`csrc/row_grad_combine.cu`), over every split table of a step in one call.

Each table t comes as (ids [N_t] int32 stored rows, any order, duplicates
allowed; g [N_t, W_t] f32 or bf16 row gradients; num_rows_t) and gets back
what `scatter_add_rows` and `sparse_adagrad_apply` take:

  * summed [N_t, W_t] f32: each distinct row's gradients summed in f32 in
    batch order, then zero rows;
  * uid [N_t] int32: the distinct rows in ascending order, then the distinct
    out-of-range ids num_rows_t + i;
  * valid [N_t] bool and n_valid [1] int32, on the device.

An id outside [0, num_rows_t) counts as row num_rows_t, which those kernels
skip. Every shape is fixed by the N_t: nothing is read back to the host, so
the call captures into a CUDA graph.

Replaces no TPU kernel: the JAX package sorts and segment-sums each table in
XLA (`recommendflow_tpu/train/optimizers.py:split_table_update`). The plain
version does that per table (a stable sort, `unique_sorted`, an f32
`index_add_`, as the split path ran it before the kernel) and runs for CPU
tensors only; for CUDA tensors the wrapper
launches the pipeline or raises. On the card the outputs are views into one
set of buffers of the call; a table's sums do not depend on which tables
share its call, and the same inputs give the same bits (no float atomics).

`combine_row_grads.launches` counts grouped calls (each a handful of
kernels: keys, CUB's radix sort, heads, scan, sums, fix-up), and
`combine_row_grads.launches_by_tables` the same calls by how many tables
each grouped.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from recommendflow_tpu_torch.ops.cuda import _build
from recommendflow_tpu_torch.ops.cuda.embedding_bag import (check_cuda,
                                                            check_ids,
                                                            unique_sorted)

_NAME = "row_grad_combine"
MAX_TABLES = 64      # csrc/row_grad_combine.cu's kMaxTables
CHUNK = 32           # sorted positions a warp sums (kChunk)
_GRAD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC8 = 2

Table = Tuple[torch.Tensor, torch.Tensor, int]          # ids, g, num_rows
Combined = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _empty(g: torch.Tensor) -> Combined:
    dev = g.device
    return (torch.zeros((0,) + tuple(g.shape[1:]), dtype=torch.float32,
                        device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
            torch.zeros(0, dtype=torch.bool, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def combine_row_grads_plain(tables: Sequence[Table]) -> List[Combined]:
    """The plain version, table by table: the stable sort, the compaction
    and the f32 sums, added in sorted order."""
    out = []
    for ids, g, num_rows in tables:
        if ids.numel() == 0:
            out.append(_empty(g))
            continue
        ids = ids.to(torch.int32)
        ids = torch.where((ids >= 0) & (ids < num_rows), ids, num_rows)
        s, order = torch.sort(ids, stable=True)
        uid, valid, n_valid, seg = unique_sorted(s, num_rows=num_rows)
        gs = g[order].float()
        summed = torch.zeros_like(gs).index_add_(0, seg, gs)
        out.append((summed, uid, valid, n_valid))
    return out


@dataclass(frozen=True)
class Layout:
    """Where a call's tables lie in its buffers. Table t holds sorted
    positions [off[t], off[t] + n[t]), chunks [chunk0[t], chunk0[t] +
    ceil(n[t] / CHUNK)), summed floats from summed_off[t] and carry floats
    (one row a chunk) from carry_off[t], each offset a multiple of 4 (16
    bytes). A key holds the table's index above `row_bits` bits of row."""
    off: Tuple[int, ...]
    chunk0: Tuple[int, ...]
    summed_off: Tuple[int, ...]
    carry_off: Tuple[int, ...]
    n_total: int
    n_chunks: int
    summed_floats: int
    carry_floats: int
    row_bits: int
    key_bits: int

    @property
    def key64(self) -> bool:
        return self.key_bits > 32


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def plan_layout(ns: Sequence[int], widths: Sequence[int],
                rows: Sequence[int]) -> Layout:
    """The buffers' layout of tables with n[t] ids (each > 0), width[t] and
    num_rows[t]. The key's row part holds 0..num_rows (an out-of-range id
    counts as num_rows), its table part 0..count-1."""
    off, chunk0, summed_off, carry_off = [], [], [], []
    pos = chunk = sf = cf = 0
    for n, w in zip(ns, widths):
        chunks = -(-n // CHUNK)
        off.append(pos)
        chunk0.append(chunk)
        summed_off.append(sf)
        carry_off.append(cf)
        pos += n
        chunk += chunks
        sf = _align4(sf + n * w)
        cf = _align4(cf + chunks * w)
    row_bits = max(rows).bit_length()
    key_bits = row_bits + (len(ns) - 1).bit_length()
    return Layout(tuple(off), tuple(chunk0), tuple(summed_off),
                  tuple(carry_off), pos, chunk, sf, cf, row_bits, key_bits)


def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    if not getattr(lib, "_typed", False):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rf_combine_temp_bytes.argtypes = [i64, i32, i32,
                                              ctypes.POINTER(i64)]
        lib.rf_combine_temp_bytes.restype = i32
        lib.rf_combine_row_grads.argtypes = [
            p, i32, i32, i32, i32, i64, i64, p, p, p, p, p, i64, p, p, p, p, p,
            p, p, p]
        lib.rf_combine_row_grads.restype = i32
        lib._typed = True
    return lib


def _temp_bytes(lib: ctypes.CDLL, layout: Layout) -> int:
    """The radix sort's scratch bytes (a host-side query, no launch)."""
    out = ctypes.c_int64(0)
    rc = lib.rf_combine_temp_bytes(layout.n_total, int(layout.key64),
                                   layout.key_bits, ctypes.byref(out))
    _build.check(lib, rc, "combine_row_grads (sort scratch)")
    return out.value


def _check_table(ids: torch.Tensor, g: torch.Tensor, rows: int) -> None:
    n = ids.shape[0] if ids.dim() == 1 else -1
    check_ids("combine_row_grads", ids, n)
    if g.dim() != 2 or g.shape[0] != n or g.dtype not in _GRAD_DTYPES \
            or not g.is_contiguous():
        raise ValueError(f"combine_row_grads: g must be a contiguous f32 or "
                         f"bf16 [{n}, W], got {g.dtype} {tuple(g.shape)}")
    if not 0 < rows < 2 ** 31 - n:
        raise ValueError(f"combine_row_grads: num_rows {rows} must lie in "
                         f"(0, 2^31 - N)")


def _launch_group(tables: Sequence[Table]) -> List[Combined]:
    """One grouped call over at most MAX_TABLES non-empty tables."""
    dev = tables[0][0].device
    ns = [ids.shape[0] for ids, _, _ in tables]
    widths = [g.shape[1] for _, g, _ in tables]
    lay = plan_layout(ns, widths, [rows for _, _, rows in tables])
    lib = _lib()
    temp = torch.empty(max(_temp_bytes(lib, lay), 1), dtype=torch.uint8,
                       device=dev)
    key_dtype = torch.int64 if lay.key64 else torch.int32
    keys_in = torch.empty(lay.n_total, dtype=key_dtype, device=dev)
    keys_out = torch.empty_like(keys_in)
    pos_in = torch.empty(lay.n_total, dtype=torch.int32, device=dev)
    pos_out = torch.empty_like(pos_in)
    heads = torch.empty(lay.n_chunks, dtype=torch.int32, device=dev)
    base = torch.empty_like(heads)
    n_valid = torch.empty(len(tables), dtype=torch.int32, device=dev)
    summed = torch.empty(lay.summed_floats, dtype=torch.float32, device=dev)
    carry = torch.empty(max(lay.carry_floats, 1), dtype=torch.float32,
                        device=dev)
    uid = torch.empty(lay.n_total, dtype=torch.int32, device=dev)
    valid = torch.empty(lay.n_total, dtype=torch.bool, device=dev)
    desc = []
    for t, (ids, g, rows) in enumerate(tables):
        vec8 = widths[t] % 8 == 0 and g.data_ptr() % 16 == 0
        desc += [ids.data_ptr(), g.data_ptr(), lay.summed_off[t],
                 lay.carry_off[t], ns[t], lay.off[t], rows, widths[t],
                 lay.chunk0[t], _GRAD_DTYPES[g.dtype] | (_VEC8 if vec8 else 0)]
    rc = lib.rf_combine_row_grads(
        (ctypes.c_int64 * len(desc))(*desc), len(tables), lay.row_bits,
        int(lay.key64), lay.key_bits, lay.n_total, lay.n_chunks,
        keys_in.data_ptr(), keys_out.data_ptr(), pos_in.data_ptr(),
        pos_out.data_ptr(), temp.data_ptr(), temp.numel(), heads.data_ptr(),
        base.data_ptr(), n_valid.data_ptr(), summed.data_ptr(),
        carry.data_ptr(), uid.data_ptr(), valid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "combine_row_grads")
    combine_row_grads.launches += 1
    by = combine_row_grads.launches_by_tables
    by[len(tables)] = by.get(len(tables), 0) + 1
    out = []
    for t in range(len(tables)):
        o, n, s = lay.off[t], ns[t], lay.summed_off[t]
        out.append((summed[s:s + n * widths[t]].view(n, widths[t]),
                    uid[o:o + n], valid[o:o + n], n_valid[t:t + 1]))
    return out


def launch_combine_row_grads(tables: Sequence[Table]) -> List[Combined]:
    """Launch the pipeline on CUDA tables: one grouped call per MAX_TABLES
    non-empty tables (an empty table gets empty outputs and n_valid 0).
    Raises on anything the kernels do not take, before any launch."""
    check_cuda("combine_row_grads", *[t for ids, g, _ in tables
                                      for t in (ids, g)])
    for ids, g, rows in tables:
        _check_table(ids, g, rows)
    out: List[Combined] = [None] * len(tables)
    live = [i for i, (ids, _, _) in enumerate(tables) if ids.shape[0] > 0]
    for i, (ids, g, _) in enumerate(tables):
        if ids.shape[0] == 0:
            out[i] = _empty(g)
    for k in range(0, len(live), MAX_TABLES):
        group = live[k:k + MAX_TABLES]
        for i, res in zip(group, _launch_group([tables[i] for i in group])):
            out[i] = res
    return out


def combine_row_grads(tables: Sequence[Table]) -> List[Combined]:
    """[(ids, g, num_rows)] -> [(summed, uid, valid, n_valid)], table by
    table (module docstring)."""
    if all(t.device.type == "cpu" for ids, g, _ in tables for t in (ids, g)):
        return combine_row_grads_plain(tables)
    return launch_combine_row_grads(tables)


combine_row_grads.launches = 0
combine_row_grads.launches_by_tables = {}
