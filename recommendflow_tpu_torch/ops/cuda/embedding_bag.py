"""Kernel 1: the embedding row gather, `out[n] = table[ids[n]]`.

Replaces `recommendflow_tpu/ops/pallas/embedding_bag.py:gather_rows` (and the
XLA take the JAX package runs in its place under `ops/embedding.py`). The CUDA
source, its bound and its design are in `csrc/embedding_bag.cu`.

`gather_rows` takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises. `gather_rows.launches` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from recommendflow_tpu_torch.ops.cuda import _build

_NAME = "embedding_bag"


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: advanced indexing, bit-identical rows."""
    return table[ids.long()]


def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    if not getattr(lib, "_typed", False):
        lib.rf_gather_rows.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_void_p]
        lib.rf_gather_rows.restype = ctypes.c_int
        lib._typed = True
    return lib


def _word_bytes(row_bytes: int, *ptrs: int) -> int:
    """Largest copy word (16..1 bytes) dividing the row and both pointers."""
    for unit in (16, 8, 4, 2, 1):
        if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    return 1


def launch_gather_rows(table: torch.Tensor, ids: torch.Tensor,
                       check_ids: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on `table [R, W]` and `ids [N] int32`.

    Raises on anything the kernel does not take: non-CUDA or mixed devices,
    a non-contiguous table, ids that are not a contiguous int32 vector, and
    (with check_ids) ids outside [0, R)."""
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
        lo, hi = torch.aminmax(ids)
        lo, hi = torch.stack([lo, hi]).tolist()
        if lo < 0 or hi >= rows:
            raise IndexError(f"gather_rows: ids span [{lo}, {hi}] outside "
                             f"the table's {rows} rows")
    row_bytes = width * table.element_size()
    unit = _word_bytes(row_bytes, table.data_ptr(), out.data_ptr())
    lib = _lib()
    rc = lib.rf_gather_rows(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                            ids.shape[0], row_bytes, unit,
                            torch.cuda.current_stream(table.device).cuda_stream)
    _build.check(lib, rc, "gather_rows")
    gather_rows.launches += 1
    return out


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [R, W] (any dtype), ids [N] int -> [N, W] rows, bit-exact."""
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return gather_rows_plain(table, ids)
    return launch_gather_rows(table, ids)


gather_rows.launches = 0
