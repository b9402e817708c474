"""`flash_attention`: softmax attention over [B, H, L, D] with an optional
[B, Lk] key mask (True = valid), differentiable in q, k and v.

Replaces `recommendflow_tpu/ops/pallas/flash_attention.py:flash_attention`
and computes the function of the vanilla SDPA the JAX `TextEncoder` runs
(`recommendflow_tpu/ops/attention.py:53-59`): masked scores at -1e9, so a
query row whose keys are all masked averages v over the Lk real keys (the
Pallas kernel pads Lk to its block and averages over the padding too). The
CUDA source, its bound and its design are in `csrc/flash_attention.cu`.

`flash_attention` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises. `flash_attention.launches` counts
launches. A call that wants no gradient goes through the custom op
`flash_attention_op` (`torch.ops.recflow.flash_attention`), which
`torch.export` keeps as one node; so does `_FlashAttention`'s forward.

The gradient on the card (`_FlashAttention`) is the vanilla maths' gradient,
in plain torch: the JAX package has no backward kernel for its Pallas
`flash_attention` (it trains through the vanilla SDPA, which XLA
differentiates outside any Pallas kernel), so neither has the port.
`flash_attention_backward` recomputes the softmax weights P in f32 from the
saved q, k and the mask, then applies the standard softmax backward. It does
so rather than differentiate `flash_attention_plain` again, so that no second
autograd graph is built inside a backward and only q, k, v and the mask are
kept for it (the kernel's output is not needed). Under `torch.no_grad()`, or
when no input needs a gradient, the kernel launches as it is and nothing is
saved.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from recommendflow_tpu_torch.ops.cuda import _build

_NAME = "flash_attention"
NEG_INF = -1e9          # the vanilla path's masked-score fill

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: the [B, H, Lq, Lk] scores in f32, masked
    to -1e9, softmax, times v, in q's dtype."""
    b, _, _, d = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    if mask is not None:
        s = s.masked_fill(~mask.reshape(b, 1, 1, -1), NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    if not getattr(lib, "_typed", False):
        lib.rf_flash_attention.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.rf_flash_attention.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel. Raises on anything it does not take. The
    output is a [B, H, Lq, D] view of a contiguous [B, Lq, H, D] buffer,
    which `merge_heads` reads without a copy."""
    dev = q.device
    tensors = [q, k, v] + ([mask] if mask is not None else [])
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention kernel needs CUDA tensors on one "
                         f"device (got {[str(t.device) for t in tensors]})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: q, k and v "
                         f"must all be float32 or all bfloat16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} are not [B, H, Lq, D] and "
                         f"[B, H, Lk, D] twice")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d < 1 or lk < 1:
        raise ValueError(f"head dim {d} or key count {lk} is below 1")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous last dim")
    if mask is not None:
        if mask.dtype != torch.bool or mask.numel() != b * lk:
            raise ValueError(f"mask {mask.dtype} {tuple(mask.shape)} is not a "
                             f"bool [B, Lk] = [{b}, {lk}] key mask")
        mask = mask.reshape(b, lk)
        if mask.stride(-1) != 1:
            raise ValueError("the key mask needs a contiguous last dim")
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 13)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        mask.stride(0) if mask is not None else 0)
    lib = _lib()
    rc = lib.rf_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        _DTYPES[q.dtype], ctypes.cast(strides, ctypes.c_void_p), b, h, lq, lk,
        d, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, mask: Optional[torch.Tensor],
                             grad_out: torch.Tensor):
    """(dq, dk, dv) of `flash_attention_plain` at (q, k, v, mask) for the
    output gradient `grad_out`, in f32 with plain torch ops, each returned
    in its input's dtype. With s = q·kᵀ/√D masked to -1e9 and P =
    softmax(s): dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − rowsum(P ⊙ dP)),
    zero where a key is masked (the -1e9 fill is a constant), dQ = dS·K/√D,
    dK = dSᵀ·Q/√D. A row whose keys are all masked has uniform P over the Lk
    keys, so its dV is dO/Lk at every key and its dQ is 0."""
    b, _, _, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, go = q.float(), k.float(), v.float(), grad_out.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    keep = None if mask is None else mask.reshape(b, 1, 1, -1)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), go)
    dp = torch.matmul(go, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    if keep is not None:
        ds = ds.masked_fill(~keep, 0.0)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@torch.library.custom_op("recflow::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel forward as a torch custom op, so that an exported program
    (`export/exporter.py`) records it as one node and launches the kernel
    when it is loaded on a card. On the CPU: the plain version, in the
    kernel's output layout (a [B, H, Lq, D] view of a contiguous
    [B, Lq, H, D] buffer), so that the op's outputs have one layout on every
    device, as the fake impl gives it. On a card: `launch_flash_attention`.
    No gradient: `flash_attention` routes a call that wants one around it
    (the plain version on the CPU, `_FlashAttention` on a card)."""
    b, h, lq, d = q.shape
    out = q.new_empty((b, lq, h, d)).transpose(1, 2)
    return out.copy_(flash_attention_plain(q, k, v, mask))


@flash_attention_op.register_kernel("cuda")
def _flash_attention_cuda(q, k, v, mask=None):
    return launch_flash_attention(q, k, v, mask)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, mask=None):
    b, h, lq, d = q.shape
    return q.new_empty((b, lq, h, d)).transpose(1, 2)


def _forward(q, k, v, mask):
    """The kernel forward: through the custom op for CPU and CUDA tensors;
    `launch_flash_attention` refuses any other device."""
    if q.device.type in ("cpu", "cuda"):
        return flash_attention_op(q, k, v, mask)
    return launch_flash_attention(q, k, v, mask)


class _FlashAttention(torch.autograd.Function):
    """The kernel forward with the vanilla maths' backward
    (`flash_attention_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _forward(q, k, v, mask)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, mask, grad_out)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(q [B, H, Lq, D], k and v [B, H, Lk, D], mask [B, Lk] bool or None)
    -> [B, H, Lq, D] in q's dtype, f32 accumulation; differentiable in q, k
    and v (on the card through `_FlashAttention`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if all(t.device.type == "cpu" for t in (q, k, v)):
            return flash_attention_plain(q, k, v, mask)
        return _FlashAttention.apply(q, k, v, mask)
    return _forward(q, k, v, mask)


flash_attention.launches = 0
