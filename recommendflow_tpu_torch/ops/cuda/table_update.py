"""`rowwise_adagrad_update`: row-wise Adagrad over a whole table, in place,

    acc[r] += mean(g[r]^2);  p[r] -= lr * g[r] * rsqrt(acc[r] + eps)

in f32 whatever the table's dtype, with one rounding back to it.

Replaces `recommendflow_tpu/ops/pallas/table_update.py:rowwise_adagrad_update`
(and the fused XLA apply of `train/optimizers.py:split_table_update`'s "dense"
strategy that the JAX trainer runs in its place). The CUDA source, its bound
and its design are in `csrc/table_update.cu`.

`rowwise_adagrad_update` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises. `rowwise_adagrad_update.launches`
counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from recommendflow_tpu_torch.ops.cuda import _build
from recommendflow_tpu_torch.ops.cuda.embedding_bag import (_TABLE_DTYPES,
                                                            check_cuda,
                                                            vec8_ok)

_NAME = "table_update"


def check_table_and_acc(what: str, p: torch.Tensor, acc: torch.Tensor) -> None:
    if p.dtype not in _TABLE_DTYPES or p.dim() != 2 or not p.is_contiguous():
        raise ValueError(f"{what}: p must be a contiguous f32 or bf16 [R, W], "
                         f"got {p.dtype} {tuple(p.shape)}")
    if acc.shape != (p.shape[0], 1) or acc.dtype != torch.float32 \
            or not acc.is_contiguous():
        raise ValueError(f"{what}: acc must be a contiguous f32 "
                         f"[{p.shape[0]}, 1], got {acc.dtype} "
                         f"{tuple(acc.shape)}")


def rowwise_adagrad_update_plain(p: torch.Tensor, acc: torch.Tensor,
                                 g: torch.Tensor, *, lr: float,
                                 eps: float = 1e-10
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, in place on p and acc; returns (p, acc)."""
    g32 = g.float()
    acc.add_((g32 * g32).mean(dim=1, keepdim=True))
    p.copy_((p.float() - lr * g32 * torch.rsqrt(acc + eps)).to(p.dtype))
    return p, acc


def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    if not getattr(lib, "_typed", False):
        lib.rf_rowwise_adagrad_update.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.rf_rowwise_adagrad_update.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_rowwise_adagrad_update(p: torch.Tensor, acc: torch.Tensor,
                                  g: torch.Tensor, *, lr: float,
                                  eps: float = 1e-10
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: p [R, W] (f32 or bf16) and acc [R, 1] f32 are
    updated in place from g [R, W] of p's dtype. Raises on anything the
    kernel does not take."""
    dev = check_cuda("rowwise_adagrad_update", p, acc, g)
    check_table_and_acc("rowwise_adagrad_update", p, acc)
    if g.shape != p.shape or g.dtype != p.dtype or not g.is_contiguous():
        raise ValueError(f"rowwise_adagrad_update: g must be contiguous "
                         f"{p.dtype} {tuple(p.shape)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    rows, width = p.shape
    if rows == 0:
        return p, acc
    lib = _lib()
    rc = lib.rf_rowwise_adagrad_update(
        p.data_ptr(), acc.data_ptr(), g.data_ptr(), rows, width, float(lr),
        float(eps), _TABLE_DTYPES[p.dtype], int(vec8_ok(width, p, g)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "rowwise_adagrad_update")
    rowwise_adagrad_update.launches += 1
    return p, acc


def rowwise_adagrad_update(p: torch.Tensor, acc: torch.Tensor,
                           g: torch.Tensor, *, lr: float, eps: float = 1e-10
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p [R, W], acc [R, 1] f32, g [R, W]) -> (p, acc), updated in place."""
    if all(t.device.type == "cpu" for t in (p, acc, g)):
        return rowwise_adagrad_update_plain(p, acc, g, lr=lr, eps=eps)
    return launch_rowwise_adagrad_update(p, acc, g, lr=lr, eps=eps)


rowwise_adagrad_update.launches = 0
