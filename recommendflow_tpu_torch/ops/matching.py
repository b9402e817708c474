"""Sequence-pair matching layers (the counterpart of
`recommendflow_tpu/ops/matching.py`): the pairwise matching matrix in five
modes and BiMPM's multi-perspective matching. Plain torch, as the JAX
package computes them outside any Pallas kernel. No model of either package
uses them yet."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

NEG_INF = -1e9
MODES = ("dot", "mul", "plus", "minus", "concat")


def matching_matrix(a: torch.Tensor, b: torch.Tensor, mode: str = "dot"
                    ) -> torch.Tensor:
    """Pairwise matching tensor of a [B, La, D] and b [B, Lb, D]: 'dot' ->
    [B, La, Lb]; 'mul' / 'plus' / 'minus' -> [B, La, Lb, D]; 'concat' ->
    [B, La, Lb, 2D]."""
    if mode == "dot":
        return torch.einsum("abd,acd->abc", a, b)
    a_e, b_e = a[:, :, None, :], b[:, None, :, :]
    if mode == "mul":
        return a_e * b_e
    if mode == "plus":
        return a_e + b_e
    if mode == "minus":
        return a_e - b_e
    if mode == "concat":
        shape = (a.shape[0], a.shape[1], b.shape[1])
        return torch.cat([a_e.expand(*shape, a.shape[-1]),
                          b_e.expand(*shape, b.shape[-1])], dim=-1)
    raise ValueError(f"unknown matching mode '{mode}' ({'/'.join(MODES)})")


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8
            ) -> torch.Tensor:
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
    return num / torch.clamp(den, min=eps)


class MultiPerspective(nn.Module):
    """BiMPM multi-perspective matching of a [B, La, D] against b [B, Lb, D]
    with `num_perspectives` learned weight vectors per strategy
    (`perspectives` [4, P, D], lecun_normal as flax draws it: fan-in 4·P),
    each strategy yielding [B, La, P]: 1. full (b's last valid position),
    2. max-pooling (max over b's positions; 0 for a row of b that is all
    padding), 3. attentive (the cosine-softmax mean of b), 4. max-attentive
    (b's first highest-cosine position). Output [B, La, 4P], zeroed where
    mask_a is False."""

    def __init__(self, dim: int, num_perspectives: int = 8, device=None):
        super().__init__()
        self.num_perspectives = num_perspectives
        self.perspectives = nn.Parameter(torch.empty(
            (4, num_perspectives, dim), device=device))
        std = math.sqrt(1.0 / (4 * num_perspectives)) / .87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.perspectives, 0.0, std, -2 * std,
                                  2 * std)

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                mask_a: Optional[torch.Tensor] = None,
                mask_b: Optional[torch.Tensor] = None) -> torch.Tensor:
        d = a.shape[-1]
        w = self.perspectives
        if mask_b is None:
            mask_b = torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)
        mb = mask_b[:, None, :]                                # [B, 1, Lb]

        def weighted(x, wk):          # [B, L, D] x [P, D] -> [B, L, P, D]
            return x[:, :, None, :] * wk[None, None, :, :]

        cos = _cosine(a[:, :, None, :], b[:, None, :, :])      # [B, La, Lb]
        cos = cos.masked_fill(~mb, NEG_INF)
        # 1. full: against b's last valid position
        lengths = torch.clamp(mask_b.sum(dim=1), min=1)
        last = b[torch.arange(b.shape[0], device=b.device), lengths - 1]
        m_full = _cosine(weighted(a, w[0]),
                         (last[:, None, :] * w[0][None])[:, None])
        # 2. max-pooling over positions of the weighted cosines
        cos_pw = _cosine(weighted(a, w[1])[:, :, None], weighted(b, w[1])[:, None])
        cos_pw = cos_pw.masked_fill(~mb[..., None], NEG_INF)   # [B, La, Lb, P]
        has_b = mask_b.any(dim=1)[:, None, None]
        m_max = torch.where(has_b, cos_pw.amax(dim=2),
                            torch.zeros((), dtype=a.dtype, device=a.device))
        # 3. attentive: the cosine-weighted mean of b
        b_att = torch.einsum("blm,bmd->bld", torch.softmax(cos, dim=2), b)
        m_att = _cosine(weighted(a, w[2]), weighted(b_att, w[2]))
        # 4. max-attentive: b's best-matching position (the first maximum)
        best = torch.argmax(cos, dim=2)                        # [B, La]
        b_best = torch.gather(b, 1, best[..., None].expand(-1, -1, d))
        m_maxatt = _cosine(weighted(a, w[3]), weighted(b_best, w[3]))
        out = torch.cat([m_full, m_max, m_att, m_maxatt], dim=-1)
        if mask_a is not None:
            out = out * mask_a[..., None].to(out.dtype)
        return out
