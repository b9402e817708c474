"""Channel fusion (the counterpart of `recommendflow_tpu/ops/fusion.py`):
Que2Search-style attention over N embedding channels, with inference-time
channel-importance statistics.

The flax module keeps the statistics in a `stats` collection and adds to
them only in an eval-mode apply whose caller made `stats` mutable
(`model.apply(..., mutable=["stats"])`); a plain apply, and so the JAX
trainer's evaluation and prediction, leaves them as they were. Here they are
two buffers, `infer_weights` [C] and `infer_count` [] (f32), and an
eval-mode forward adds to them only inside `collecting_stats(model)`:
`Trainer.evaluate` and `predict` leave them unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Sequence

import torch
from torch import nn


class AttentionFusion(nn.Module):
    """softmax(att([channels])) weighted sum of C per-channel embeddings
    [B, D] (same D): `att` is the flax Dense over the flattened [B, C*D]."""

    def __init__(self, num_channels: int, channel_dim: int, device=None):
        super().__init__()
        self.num_channels = num_channels
        self.collect_stats = False
        self.att = nn.Linear(num_channels * channel_dim, num_channels,
                             device=device)
        self.register_buffer("infer_weights",
                             torch.zeros(num_channels, device=device))
        self.register_buffer("infer_count", torch.zeros((), device=device))

    def forward(self, channels: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(channels) != self.num_channels:
            raise ValueError(f"expected {self.num_channels} channels, got "
                             f"{len(channels)}")
        stacked = torch.stack(list(channels), dim=1)          # [B, C, D]
        b, c, d = stacked.shape
        weights = torch.softmax(self.att(stacked.reshape(b, c * d)), dim=-1)
        if not self.training and self.collect_stats:
            with torch.no_grad():
                self.infer_weights.add_(weights.mean(dim=0))
                self.infer_count.add_(1.0)
        return torch.einsum("bc,bcd->bd", weights, stacked)


@contextlib.contextmanager
def collecting_stats(model: nn.Module) -> Iterator[nn.Module]:
    """Within the block, eval-mode forwards of every AttentionFusion under
    `model` add their mean channel weights to its statistics (flax's
    `mutable=["stats"]`)."""
    fusions = [m for m in model.modules() if isinstance(m, AttentionFusion)]
    for m in fusions:
        m.collect_stats = True
    try:
        yield model
    finally:
        for m in fusions:
            m.collect_stats = False


def channel_importance(stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean fusion weights accumulated during inference: infer_weights /
    max(infer_count, 1). `stats` is a dict with those two keys (a fusion
    module's buffers, `dict(fusion.named_buffers())`)."""
    return stats["infer_weights"] / torch.clamp(stats["infer_count"], min=1.0)
