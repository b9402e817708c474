"""`sparse_adagrad_apply`: row-wise Adagrad on the touched rows only, from
compacted f32 row gradients (unique ids, duplicates already summed):

    for i < n_valid with 0 <= uid[i] < R, r = uid[i]:
        acc[r] += mean(gs[i]^2);  p[r] -= lr * gs[i] * rsqrt(acc[r] + eps)

in f32, one rounding back to p's dtype; every other row of p and acc keeps
its bits.

Replaces `recommendflow_tpu/ops/pallas/sparse_apply.py:sparse_adagrad_apply`
(with `_compact_sorted` and `split_update_pallas`), and the gather / compute /
sorted scatter-SET of `train/optimizers.py:split_table_update`'s "sparse_set"
strategy that the JAX trainer runs. The CUDA source, its bound and its design
are in `csrc/sparse_apply.cu`.

`sparse_adagrad_apply` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises. `sparse_adagrad_apply.launches`
counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from recommendflow_tpu_torch.ops.cuda import _build
from recommendflow_tpu_torch.ops.cuda.embedding_bag import (_TABLE_DTYPES,
                                                            check_cuda,
                                                            check_ids,
                                                            device_count,
                                                            valid_prefix,
                                                            vec8_ok)
from recommendflow_tpu_torch.ops.cuda.table_update import check_table_and_acc

_NAME = "sparse_apply"


def sparse_adagrad_apply_plain(p: torch.Tensor, acc: torch.Tensor,
                               uid: torch.Tensor, gs: torch.Tensor,
                               n_valid: Optional[torch.Tensor] = None, *,
                               lr: float, eps: float = 1e-10
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, in place on p and acc; returns (p, acc)."""
    n = valid_prefix(n_valid, uid.shape[0])
    rows = uid[:n].long()
    keep = (rows >= 0) & (rows < p.shape[0])
    rows, g = rows[keep], gs[:n][keep].float()
    a = acc[rows] + (g * g).mean(dim=1, keepdim=True)
    acc[rows] = a
    p[rows] = (p[rows].float() - lr * g * torch.rsqrt(a + eps)).to(p.dtype)
    return p, acc


def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    if not getattr(lib, "_typed", False):
        lib.rf_sparse_adagrad_apply.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.rf_sparse_adagrad_apply.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_sparse_adagrad_apply(p: torch.Tensor, acc: torch.Tensor,
                                uid: torch.Tensor, gs: torch.Tensor,
                                n_valid: Optional[torch.Tensor] = None, *,
                                lr: float, eps: float = 1e-10
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel: p [R, W] (f32 or bf16) and acc [R, 1] f32 are
    updated in place from uid [N] int32 (unique) and gs [N, W] f32;
    `n_valid` (one int32 on the card) bounds the entries read, and uids
    outside [0, R) are skipped. Raises on anything the kernel does not take."""
    dev = check_cuda("sparse_adagrad_apply", p, acc, uid, gs)
    check_table_and_acc("sparse_adagrad_apply", p, acc)
    rows, width = p.shape
    n = gs.shape[0]
    if gs.shape != (n, width) or gs.dtype != torch.float32 \
            or not gs.is_contiguous():
        raise ValueError(f"sparse_adagrad_apply: gs must be contiguous f32 "
                         f"[N, {width}], got {gs.dtype} {tuple(gs.shape)}")
    check_ids("sparse_adagrad_apply", uid, n)
    nv = device_count(n_valid, n, dev)
    if n == 0:
        return p, acc
    lib = _lib()
    rc = lib.rf_sparse_adagrad_apply(
        p.data_ptr(), acc.data_ptr(), uid.data_ptr(), gs.data_ptr(),
        nv.data_ptr(), n, rows, width, float(lr), float(eps),
        _TABLE_DTYPES[p.dtype], int(vec8_ok(width, p, gs)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "sparse_adagrad_apply")
    sparse_adagrad_apply.launches += 1
    return p, acc


def sparse_adagrad_apply(p: torch.Tensor, acc: torch.Tensor,
                         uid: torch.Tensor, gs: torch.Tensor,
                         n_valid: Optional[torch.Tensor] = None, *,
                         lr: float, eps: float = 1e-10
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p [R, W], acc [R, 1] f32, uid [N] int32, gs [N, W] f32, n_valid)
    -> (p, acc), the touched rows updated in place."""
    if all(t.device.type == "cpu" for t in (p, acc, uid, gs)):
        return sparse_adagrad_apply_plain(p, acc, uid, gs, n_valid, lr=lr,
                                          eps=eps)
    return launch_sparse_adagrad_apply(p, acc, uid, gs, n_valid, lr=lr,
                                       eps=eps)


sparse_adagrad_apply.launches = 0
