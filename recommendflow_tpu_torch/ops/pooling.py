"""Pooling layers: k-max and MatchPyramid dynamic pooling (the counterpart
of `recommendflow_tpu/ops/pooling.py`). Plain torch, as the JAX package
computes them outside any Pallas kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def kmax_pooling(x: torch.Tensor, k: int, dim: int = -1) -> torch.Tensor:
    """The k largest values along `dim`, in descending order (lax.top_k)."""
    return torch.topk(x, k, dim=dim, largest=True, sorted=True).values


def dynamic_max_pooling(match: torch.Tensor, out_h: int, out_w: int
                        ) -> torch.Tensor:
    """Max-pool a [B, H, W] (or [B, H, W, C]) match matrix to a fixed
    [B, out_h, out_w(, C)] grid. H and W are padded up to multiples of the
    grid by repeating the last row and column (edge padding), then pooled
    in windows of (H_pad / out_h, W_pad / out_w)."""
    squeeze = match.dim() == 3
    if squeeze:
        match = match[..., None]
    _, h, w, _ = match.shape
    ph = -(-h // out_h) * out_h
    pw = -(-w // out_w) * out_w
    x = match.permute(0, 3, 1, 2)                            # [B, C, H, W]
    if ph > h or pw > w:
        x = F.pad(x, (0, pw - w, 0, ph - h), mode="replicate")
    pooled = F.max_pool2d(x, (ph // out_h, pw // out_w))
    pooled = pooled.permute(0, 2, 3, 1)
    return pooled[..., 0] if squeeze else pooled
