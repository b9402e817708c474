"""`grouped_score_max`: the fused score + group-max scan of exact top-k
retrieval, `m1[q, g] = max over the G items of group g of (q·v or
2q·v − ‖v‖²)`, items at or past `num_items` scoring NEG.

Replaces `recommendflow_tpu/ops/pallas/grouped_topk.py:grouped_score_max`,
with the output untransposed (`[Q, N_pad/G]`), for f32, bf16 and uint8 (SQ8
code) corpora. The corpus type picks the kernel: an FP32 SIMT kernel for an
f32 corpus, a bf16 tensor-core (`wgmma`) kernel for a bf16 or uint8 corpus,
which takes the queries as a bf16 tensor. The CUDA source,
its bounds and its designs are in `csrc/grouped_topk.cu`.

`grouped_score_max` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises. `grouped_score_max.launches` counts
launches, `grouped_score_max.launches_by_dtype` the same launches by corpus
type ("float32", "bfloat16", "uint8").
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from recommendflow_tpu_torch.ops.cuda import _build

_NAME = "grouped_topk"
NEG = -1e30
GROUPS = (4, 8, 16, 32, 64)   # group sizes the kernel takes

_VEC_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def _query_operand(queries: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Queries as the kernel multiplies them: f32, rounded through bf16 first
    for a bf16 or uint8 corpus (the Pallas kernel feeds the MXU a bf16 x bf16
    product, grouped_topk.py:84-87, the uint8 codes cast to bf16 exactly;
    products of bf16 values and codes <= 255 are exact in f32)."""
    q = queries.float()
    if vecs.dtype in (torch.bfloat16, torch.uint8):
        q = q.to(torch.bfloat16).float()
    return q


def grouped_score_max_plain(queries: torch.Tensor, vecs: torch.Tensor,
                            sq_norms: Optional[torch.Tensor], *, group: int,
                            num_items: int) -> torch.Tensor:
    """The plain PyTorch version: the full [Q, N_pad] score matrix, masked,
    then the max over each run of `group` items (a bf16 or uint8 corpus
    widened to f32, exactly)."""
    n_pad = vecs.shape[0]
    s = _query_operand(queries, vecs) @ vecs.float().T
    # in place: at Q = 4096 over a 1M-item corpus s alone is 17 GB
    if sq_norms is not None:
        s.mul_(2.0).sub_(sq_norms.float()[None, :])
    s[:, num_items:] = NEG
    return s.view(queries.shape[0], n_pad // group, group).amax(dim=-1)


def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    if not getattr(lib, "_typed", False):
        lib.rf_grouped_score_max.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        lib.rf_grouped_score_max.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_grouped_score_max(queries: torch.Tensor, vecs: torch.Tensor,
                             sq_norms: Optional[torch.Tensor], *, group: int,
                             num_items: int) -> torch.Tensor:
    """Launch the CUDA kernel. Raises on anything it does not take."""
    dev = vecs.device
    tensors = [queries, vecs] + ([sq_norms] if sq_norms is not None else [])
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("grouped_score_max kernel needs CUDA tensors on one "
                         f"device (got {[str(t.device) for t in tensors]})")
    if vecs.dtype not in _VEC_DTYPES:
        raise ValueError(f"corpus dtype {vecs.dtype} not supported "
                         f"(float32, bfloat16, uint8)")
    if queries.dim() != 2 or vecs.dim() != 2 or queries.shape[1] != vecs.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} x {tuple(vecs.shape)} "
                         f"are not [Q, D] x [N_pad, D]")
    n_pad, d = vecs.shape
    if group not in GROUPS or n_pad % group:
        raise ValueError(f"group {group} must be one of {GROUPS} and divide "
                         f"N_pad = {n_pad}")
    if sq_norms is not None and (sq_norms.shape != (n_pad,)
                                 or sq_norms.dtype != torch.float32):
        raise ValueError("sq_norms must be a float32 [N_pad] vector")
    if not 0 <= num_items <= n_pad:
        raise ValueError(f"num_items {num_items} outside [0, {n_pad}]")
    q = _query_operand(queries, vecs)
    if vecs.dtype != torch.float32:
        q = q.to(torch.bfloat16)      # exact: the values are bf16 already
    q = q.contiguous()
    v = vecs.contiguous()
    sqn = sq_norms.contiguous() if sq_norms is not None else None
    nq = q.shape[0]
    m1 = torch.empty((nq, n_pad // group), dtype=torch.float32, device=dev)
    if nq == 0 or n_pad == 0:
        return m1
    lib = _lib()
    rc = lib.rf_grouped_score_max(
        q.data_ptr(), v.data_ptr(), _VEC_DTYPES[v.dtype],
        sqn.data_ptr() if sqn is not None else None, m1.data_ptr(), nq,
        n_pad, d, group, int(num_items),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "grouped_score_max")
    grouped_score_max.launches += 1
    grouped_score_max.launches_by_dtype[str(v.dtype).split(".")[-1]] += 1
    return m1


def grouped_score_max(queries: torch.Tensor, vecs: torch.Tensor,
                      sq_norms: Optional[torch.Tensor], *, group: int,
                      num_items: int) -> torch.Tensor:
    """(queries [Q, D], vecs [N_pad, D] f32, bf16 or uint8, sq_norms [N_pad]
    or None)
    -> m1 [Q, N_pad / group] f32 group maxima of the masked score matrix."""
    if vecs.device.type == "cpu" and queries.device.type == "cpu":
        return grouped_score_max_plain(queries, vecs, sq_norms, group=group,
                                       num_items=num_items)
    return launch_grouped_score_max(queries, vecs, sq_norms, group=group,
                                    num_items=num_items)


grouped_score_max.launches = 0
grouped_score_max.launches_by_dtype = {"float32": 0, "bfloat16": 0, "uint8": 0}
