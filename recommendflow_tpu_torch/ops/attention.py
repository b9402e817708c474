"""Attention layers (the counterpart of `recommendflow_tpu/ops/attention.py`).

`scaled_dot_product_attention` keeps the JAX layout: q, k, v of rank 3
([B, L, D]) or 4 ([B, H, L, D]) with an optional mask (True = valid), either
a key mask ([B, Lk], [B, 1, Lk]) or a full mask whose rank equals q's. With
no mask or a key mask it goes to `flash_attention` (`ops/cuda/
flash_attention.py`): the kernel for card tensors, its plain version (the
vanilla maths: scores at -1e9 where masked, softmax) for CPU tensors. A full
mask (the UniLM mask of SimBERT training, `[B, 1, Lq, Lk]`) runs the vanilla
maths in plain torch on every device, as the JAX package computes it outside
its kernel (`recommendflow_tpu/ops/attention.py:53-59`): kernel 6 takes key
masks only.

Modules carry the flax names of their parameters (`q`, `k`, `v`, `out`,
`gate`, `key`, `query`), so `interop.py` maps a flax tree onto them. Layers
whose width the JAX module reads off its input take it as a constructor
argument here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from recommendflow_tpu_torch.ops.cuda.flash_attention import flash_attention

NEG_INF = -1e9


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """SDPA over rank 3 or 4 inputs (module docstring)."""
    if mask is not None and mask.dim() == q.dim():
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(k.shape[-1])
        logits = logits.masked_fill(~mask, NEG_INF)
        return torch.matmul(torch.softmax(logits, dim=-1), v)
    kmask = None if mask is None else mask.reshape(q.shape[0], -1)
    if q.dim() == 3:
        return flash_attention(q[:, None], k[:, None], v[:, None], kmask)[:, 0]
    if q.dim() == 4:
        return flash_attention(q, k, v, kmask)
    raise ValueError(f"attention takes rank 3 or 4 inputs, got {q.dim()}")


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, H*D] -> [B, H, L, D], a view."""
    b, l, hd = x.shape
    return x.view(b, l, num_heads, hd // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, D] -> [B, L, H*D]; a view when x is the transpose of a
    contiguous [B, L, H, D] (the kernel's output)."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def sinusoidal_position_encoding(length: int, dim: int,
                                 dtype=torch.float32,
                                 device=None) -> torch.Tensor:
    """Standard sin/cos positional encoding [L, D]."""
    pos = torch.arange(length, dtype=dtype, device=device)[:, None]
    i = torch.arange(dim, dtype=dtype, device=device)[None, :]
    # the base filled on the device (no host copy: a CUDA graph captures
    # this), rounded to dtype as a host scalar tensor would be
    base = torch.full((), 10000.0, dtype=dtype, device=device)
    angle = pos / torch.pow(base,
                            (2 * torch.div(i, 2, rounding_mode="floor")) / dim)
    return torch.where(i % 2 == 0, torch.sin(angle), torch.cos(angle))


class MultiHeadAttention(nn.Module):
    """q/k/v projection multi-head attention; the Linear layers carry the
    flax names q, k, v and out (`interop.py`)."""

    def __init__(self, model_dim: int, num_heads: int,
                 head_dim: Optional[int] = None, out_dim: Optional[int] = None,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        inner = num_heads * (head_dim or model_dim // num_heads)
        self.q = nn.Linear(model_dim, inner, device=device)
        self.k = nn.Linear(model_dim, inner, device=device)
        self.v = nn.Linear(model_dim, inner, device=device)
        self.out = nn.Linear(inner, out_dim or model_dim, device=device)

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor,
                v_in: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = split_heads(self.q(q_in), self.num_heads)
        k = split_heads(self.k(k_in), self.num_heads)
        v = split_heads(self.v(v_in), self.num_heads)
        # mask: [B, Lk] key mask or [B, Lq, Lk] full mask, both given a head
        # axis; SDPA tells them apart by rank against q
        kmask = mask[:, None] if mask is not None else None
        out = scaled_dot_product_attention(q, k, v, kmask)
        return self.out(merge_heads(out))


class SelfAttention(nn.Module):
    """Single-head self-attention with sinusoidal positions and a masked
    mean pool: [B, L, D] (mask [B, L], True = valid) -> [B, D]. The
    attention reaches flash_attention as [B, 1, L, D]."""

    def __init__(self, dim: int, use_position: bool = True, device=None):
        super().__init__()
        self.use_position = use_position
        self.q = nn.Linear(dim, dim, device=device)
        self.k = nn.Linear(dim, dim, device=device)
        self.v = nn.Linear(dim, dim, device=device)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        _, l, d = x.shape
        if self.use_position:
            x = x + sinusoidal_position_encoding(l, d, x.dtype, x.device)[None]
        out = scaled_dot_product_attention(self.q(x), self.k(x), self.v(x),
                                           mask)
        if mask is None:
            return out.mean(dim=1)
        m = mask[..., None].to(out.dtype)
        return (out * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def soft_attention_align(a: torch.Tensor, b: torch.Tensor,
                         mask_a: Optional[torch.Tensor] = None,
                         mask_b: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ESIM soft alignment, two softmaxes over one score matrix:
    a [B, La, D], b [B, Lb, D] -> (a aligned from b, b aligned from a).
    Plain torch, as the JAX package computes it outside Pallas."""
    e = torch.einsum("bld,bmd->blm", a, b)            # [B, La, Lb]
    ea = e if mask_b is None else e.masked_fill(~mask_b[:, None, :], NEG_INF)
    eb = e if mask_a is None else e.masked_fill(~mask_a[:, :, None], NEG_INF)
    a_att = torch.softmax(ea, dim=2)                  # weights over b
    b_att = torch.softmax(eb, dim=1)                  # weights over a
    return (torch.einsum("blm,bmd->bld", a_att, b),
            torch.einsum("blm,bld->bmd", b_att, a))


def esim_enhance(x: torch.Tensor, aligned: torch.Tensor) -> torch.Tensor:
    """ESIM local-inference enhancement: [x; aligned; x-aligned; x*aligned]."""
    return torch.cat([x, aligned, x - aligned, x * aligned], dim=-1)


class ItemSimilarityGating(nn.Module):
    """FISSA's sigmoid gate over the [item, global, candidate] concat
    (`in_features` wide) -> [..., 1]."""

    def __init__(self, in_features: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.drop = nn.Dropout(dropout)
        self.gate = nn.Linear(in_features, 1, device=device)

    def forward(self, item_emb: torch.Tensor, global_emb: torch.Tensor,
                candidate_emb: torch.Tensor) -> torch.Tensor:
        x = torch.cat([item_emb, global_emb, candidate_emb], dim=-1)
        return torch.sigmoid(self.gate(self.drop(x)))


class LocationBasedAttention(nn.Module):
    """FISSA's LBA pooling: a learnable query [D, 1] attends the bias-free
    key projection of x [B, L, D] (scores / √D, -1e9 where masked, softmax);
    the weights pool `values` (default x, [B, L, V]), and a bias-free `out`
    layer projects the pooled [B, V] back to V. `query` is drawn as flax's
    lecun_normal (a normal truncated at two standard deviations, variance
    1/D)."""

    def __init__(self, dim: int, value_dim: Optional[int] = None,
                 device=None):
        super().__init__()
        value_dim = value_dim or dim
        self.key = nn.Linear(dim, dim, bias=False, device=device)
        self.query = nn.Parameter(torch.empty((dim, 1), device=device))
        self.out = nn.Linear(value_dim, value_dim, bias=False, device=device)
        std = math.sqrt(1.0 / dim) / .87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.query, 0.0, std, -2 * std, 2 * std)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                values: Optional[torch.Tensor] = None) -> torch.Tensor:
        d = x.shape[-1]
        v = x if values is None else values
        logits = (self.key(x) @ self.query)[..., 0] / math.sqrt(float(d))
        if mask is not None:
            logits = logits.masked_fill(~mask, NEG_INF)
        w = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bl,bld->bd", w, v))
