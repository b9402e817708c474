"""The embedding row kernels of `csrc/embedding_bag.cu`:

  * `gather_rows`: `out[n] = table[ids[n]]`. Replaces
    `recommendflow_tpu/ops/pallas/embedding_bag.py:gather_rows` (and the XLA
    take the JAX package runs in its place under `ops/embedding.py`). The
    kernel asserts on the card for an id outside [0, R) before it reads the
    row. A direct call also checks the ids' range on the host first
    (IndexError), which makes the host wait for the card; the model paths
    pass `check_ids=False`, because the host checked every batch's ids
    before they were copied (`data/schema.py:check_batch_ids`), where the
    JAX package's take fills a NaN row or wraps.
  * `scatter_add_rows`: `table[ids[n]] += grads[n]` for the first `n_valid`
    unique ids, summed in f32 and rounded once to the table's dtype. Replaces
    `recommendflow_tpu/ops/pallas/embedding_bag.py:scatter_add_rows` (and the
    sorted XLA scatter-add of `take_rows`' backward and of
    `train/optimizers.py:split_table_update`'s "dense" strategy). Its input
    comes from `segment_row_grads`, the sorted duplicate sum (plain torch).

The CUDA source, the bounds and the designs are in `csrc/embedding_bag.cu`.
Each wrapper takes its plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises. `<wrapper>.launches` counts launches,
`gather_rows.launches_by_row_bytes` the same launches by row width.
`gather_rows_op` (`torch.ops.recflow.gather_rows`) is the embed pass's gather
as a torch custom op, which `torch.export` keeps as one node.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from recommendflow_tpu_torch.ops.cuda import _build

_NAME = "embedding_bag"
_TABLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: advanced indexing, bit-identical rows."""
    return table[ids.long()]


def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    if not getattr(lib, "_typed", False):
        lib.rf_gather_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_void_p]
        lib.rf_gather_rows.restype = ctypes.c_int
        lib.rf_scatter_add_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.rf_scatter_add_rows.restype = ctypes.c_int
        lib._typed = True
    return lib


def _word_bytes(row_bytes: int, *ptrs: int) -> int:
    """Largest copy word (16..1 bytes) dividing the row and both pointers."""
    for unit in (16, 8, 4, 2, 1):
        if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    return 1


def vec8_ok(width: int, *tensors: torch.Tensor) -> bool:
    """True when rows can move as 16-byte words of 8 elements: the width is
    a multiple of 8 and every base pointer is 16-byte aligned."""
    return width % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def check_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} kernel needs CUDA tensors on one device "
                         f"(got {[str(t.device) for t in tensors]})")
    return dev


def check_ids(what: str, ids: torch.Tensor, n: int) -> None:
    if (ids.dim() != 1 or ids.shape[0] != n or ids.dtype != torch.int32
            or not ids.is_contiguous()):
        raise ValueError(f"{what}: ids must be a contiguous int32 [{n}] "
                         f"vector, got {ids.dtype} {tuple(ids.shape)}")


def device_count(n_valid: Optional[torch.Tensor], n: int,
                 dev: torch.device) -> torch.Tensor:
    """n_valid as the kernels read it: one int32 in device memory (never
    read back by the host). None means all n entries."""
    if n_valid is None:
        return torch.full((1,), n, dtype=torch.int32, device=dev)
    if (n_valid.numel() != 1 or n_valid.dtype != torch.int32
            or n_valid.device != dev):
        raise ValueError(f"n_valid must be one int32 on {dev}, got "
                         f"{n_valid.dtype} {tuple(n_valid.shape)} on "
                         f"{n_valid.device}")
    return n_valid.reshape(1).contiguous()


def valid_prefix(n_valid: Optional[torch.Tensor], n: int) -> int:
    """The plain versions' reading of n_valid (a host read)."""
    return n if n_valid is None else min(int(n_valid.reshape(-1)[0]), n)


def check_id_range(ids: torch.Tensor, rows: int) -> None:
    """IndexError unless every id lies in [0, rows). On a card the host
    waits for the ids' min and max."""
    if ids.numel() == 0:
        return
    lo, hi = torch.aminmax(ids)
    lo, hi = torch.stack([lo, hi]).tolist()
    if lo < 0 or hi >= rows:
        raise IndexError(f"gather_rows: ids span [{lo}, {hi}] outside "
                         f"the table's {rows} rows")


def launch_gather_rows(table: torch.Tensor, ids: torch.Tensor,
                       check_ids: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on `table [R, W]` and `ids [N] int32`.

    Raises on anything the kernel does not take: non-CUDA or mixed devices,
    a non-contiguous table, ids that are not a contiguous int32 vector, and
    (with check_ids) ids outside [0, R), before anything is launched.
    Without check_ids the host does not wait: the kernel itself stops with
    a device-side assert at an id outside [0, R), before reading its row."""
    if table.device.type != "cuda" or ids.device != table.device:
        raise ValueError(f"gather_rows kernel needs CUDA tensors on one "
                         f"device (table {table.device}, ids {ids.device})")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous [R, W] tensor, got "
                         f"{tuple(table.shape)}")
    if ids.dim() != 1 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError(f"ids must be a contiguous int32 vector, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    rows, width = table.shape
    out = torch.empty((ids.shape[0], width), dtype=table.dtype,
                      device=table.device)
    if ids.shape[0] == 0:
        return out
    if check_ids:
        check_id_range(ids, rows)
    row_bytes = width * table.element_size()
    unit = _word_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    lib = _lib()
    rc = lib.rf_gather_rows(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                            ids.shape[0], row_bytes, rows, unit,
                            torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(lib, rc, "gather_rows")
    gather_rows.launches += 1
    by_width = gather_rows.launches_by_row_bytes
    by_width[row_bytes] = by_width.get(row_bytes, 0) + 1
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                check_ids: bool = True) -> torch.Tensor:
    """table [R, W] (any dtype), ids [N] int -> [N, W] rows, bit-exact.
    An id outside [0, R) raises IndexError on the CPU. On a card, check_ids
    raises it before the launch (the host waits for the check); off where
    the ids were checked already, the kernel's own device-side assert is the
    only check."""
    if table.device.type == "cpu" and ids.device.type == "cpu":
        check_id_range(ids, table.shape[0])
        return gather_rows_plain(table, ids)
    return launch_gather_rows(table, ids, check_ids=check_ids)


gather_rows.launches = 0
gather_rows.launches_by_row_bytes = {}


@torch.library.custom_op("recflow::gather_rows", mutates_args=(),
                         device_types="cpu")
def gather_rows_op(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`gather_rows` as a torch custom op, the embed pass's gather, so that an
    exported program (`export/exporter.py`) records it as one node and runs
    the kernel when it is loaded on a card. On the CPU: the range check
    (IndexError) and the plain version. On a card: the kernel without the
    host check (`launch_gather_rows(..., check_ids=False)`; the ids were
    checked on the host before they were copied), counted in
    `gather_rows.launches`. No other device has a kernel (meta tensors get
    the fake impl's shapes, as in tracing)."""
    check_id_range(ids, table.shape[0])
    return gather_rows_plain(table, ids)


@gather_rows_op.register_kernel("cuda")
def _gather_rows_cuda(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return launch_gather_rows(table, ids, check_ids=False)


@gather_rows_op.register_fake
def _gather_rows_fake(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table.new_empty((ids.shape[0], table.shape[1]))


def unique_sorted(s: torch.Tensor, *, num_rows: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """The unique ids of SORTED ids, at a fixed size: s [N] sorted int ids
    (N > 0) -> (uid [N] int32: the unique ids in order, then the DISTINCT
    out-of-range ids num_rows + i, so the vector stays sorted and unique,
    valid [N] bool, n_valid [1] int32 on the device, seg [N]: each entry's
    index in uid). Every shape is fixed by N: nothing here reads a value
    back to the host, where `torch.unique`'s output size would make the host
    wait for the card."""
    n = s.shape[0]
    dev = s.device
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = s[1:] != s[:-1]
    seg = torch.cumsum(first, 0) - 1                  # [N] segment index
    # every member of a segment writes the same id: the result is exact
    uid = torch.zeros(n, dtype=torch.int32, device=dev).scatter_(
        0, seg, s.to(torch.int32))
    n_valid = (seg[-1:] + 1).to(torch.int32)
    pos = torch.arange(n, device=dev)
    valid = pos < n_valid
    uid = torch.where(valid, uid, (num_rows + pos).to(torch.int32))
    return uid, valid, n_valid, seg


def segment_row_grads(s: torch.Tensor, gs: torch.Tensor, *, num_rows: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Combine duplicate SORTED row gradients into per-unique-row sums: the
    input scatter_add_rows and sparse_adagrad_apply take (the counterpart of
    `_combine_duplicates` and `train/optimizers.py:segment_row_grads` in the
    JAX package).

    s [N] sorted int ids, gs [N, W] f32 grads in the same order ->
    (summed [N, W] f32 with zero padding rows, uid [N] int32, valid [N] bool
    and n_valid [1] int32 on the device, as `unique_sorted` gives them).
    Nothing here reads a value back to the host."""
    n = s.shape[0]
    dev = s.device
    if n == 0:
        return (gs.new_zeros(gs.shape), s.to(torch.int32),
                torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))
    uid, valid, n_valid, seg = unique_sorted(s, num_rows=num_rows)
    summed = torch.zeros_like(gs).index_add_(0, seg, gs)
    return summed, uid, valid, n_valid


def scatter_add_rows_plain(ids: torch.Tensor, grads: torch.Tensor,
                           table: torch.Tensor,
                           n_valid: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The plain PyTorch version, in place: for n < n_valid with ids[n] in
    [0, R), table[ids[n]] = round(table[ids[n]] + grads[n]) with the sum in
    f32. ids must be unique."""
    n = valid_prefix(n_valid, ids.shape[0])
    rows = ids[:n].long()
    keep = (rows >= 0) & (rows < table.shape[0])
    rows, g = rows[keep], grads[:n][keep].float()
    table[rows] = (table[rows].float() + g).to(table.dtype)
    return table


def launch_scatter_add_rows(ids: torch.Tensor, grads: torch.Tensor,
                            table: torch.Tensor,
                            n_valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Launch the CUDA kernel: `table [R, W]` (f32 or bf16, contiguous) is
    updated in place from `ids [N] int32` (unique) and `grads [N, W] f32`.
    `n_valid` (one int32 on the card) bounds the entries read; ids outside
    [0, R) are skipped. Raises on anything the kernel does not take."""
    dev = check_cuda("scatter_add_rows", ids, grads, table)
    if table.dtype not in _TABLE_DTYPES or table.dim() != 2 \
            or not table.is_contiguous():
        raise ValueError(f"scatter_add_rows: table must be a contiguous f32 "
                         f"or bf16 [R, W], got {table.dtype} "
                         f"{tuple(table.shape)}")
    rows, width = table.shape
    n = grads.shape[0]
    if grads.shape != (n, width) or grads.dtype != torch.float32 \
            or not grads.is_contiguous():
        raise ValueError(f"scatter_add_rows: grads must be contiguous f32 "
                         f"[N, {width}], got {grads.dtype} "
                         f"{tuple(grads.shape)}")
    check_ids("scatter_add_rows", ids, n)
    nv = device_count(n_valid, n, dev)
    if n == 0:
        return table
    lib = _lib()
    rc = lib.rf_scatter_add_rows(
        ids.data_ptr(), grads.data_ptr(), table.data_ptr(), nv.data_ptr(), n,
        rows, width, _TABLE_DTYPES[table.dtype],
        int(vec8_ok(width, grads, table)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return table


def scatter_add_rows(ids: torch.Tensor, grads: torch.Tensor,
                     table: torch.Tensor,
                     n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In place `table[ids[:n_valid]] += grads[:n_valid]` (unique ids, f32
    sums, one rounding); returns table."""
    if all(t.device.type == "cpu" for t in (ids, grads, table)):
        return scatter_add_rows_plain(ids, grads, table, n_valid)
    return launch_scatter_add_rows(ids, grads, table, n_valid)


scatter_add_rows.launches = 0
