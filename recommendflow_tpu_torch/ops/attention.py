"""Attention layers (the counterpart of `recommendflow_tpu/ops/attention.py`
:20-104; `SelfAttention`, `soft_attention_align`, `esim_enhance`,
`ItemSimilarityGating` and `LocationBasedAttention` come with the ranking
slice).

`scaled_dot_product_attention` keeps the JAX layout: q, k, v of rank 3
([B, L, D]) or 4 ([B, H, L, D]) with an optional mask (True = valid), either
a key mask ([B, Lk], [B, 1, Lk]) or a full mask whose rank equals q's. With
no mask or a key mask it goes to `flash_attention` (`ops/cuda/
flash_attention.py`): the kernel for card tensors, its plain version (the
vanilla maths: scores at -1e9 where masked, softmax) for CPU tensors. A full
mask runs the vanilla maths on the CPU and raises on the card, as the JAX
kernel path does (`recommendflow_tpu/ops/attention.py:32-35`).
"""
from __future__ import annotations

import math
from typing import Optional

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
        if q.device.type != "cpu":
            raise ValueError(
                "the flash_attention kernel takes key masks only; got a full "
                f"attention mask of shape {tuple(mask.shape)}")
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
    angle = pos / torch.pow(torch.tensor(10000.0, dtype=dtype, device=device),
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
