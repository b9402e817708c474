"""Mobius-style relevance-gated recall (the counterpart of
`recommendflow_tpu/models/matching/mobius.py`).

Shared MLP towers (`user_tower`, `ad_tower`) feed two heads each: business
embeddings (`user_biz`, `ad_biz`) and relevance-judge embeddings
(`user_rel`, `ad_rel`), all L2-normalised. Training adds both heads' in-batch
losses and mines cross-batch pairs the judge deems irrelevant (its detached
cosine below `relevance_threshold`, off the diagonal) whose business score
is high: their clip(score, 0)^2, averaged over the mined pairs, weighs
`mobius_weight`. Eval returns the business vectors and `relevance`, the
judge's per-row cosine. Both towers come from one embed pass
(row_injection).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import get_labels
from recommendflow_tpu_torch.ops.mlp import MLP, l2_normalize


class Mobius(RecModel):
    """Networks key: embedding_dim (128); the rest are constructor
    arguments, as the JAX fields are. In training mode the forward returns
    (loss, {'mobius_loss', 'rel_loss', 'hard_frac'})."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None,
                 tower_units: Sequence[int] = (256, 128),
                 relevance_threshold: float = 0.3, mobius_weight: float = 0.5,
                 dropout: float = 0.1, device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.relevance_threshold = relevance_threshold
        self.mobius_weight = mobius_weight
        out_dim = int(self.network_conf("embedding_dim") or 128)
        units = list(tower_units) + [out_dim]
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev)
        for tower in ("user", "ad"):
            self.add_module(f"{tower}_tower", MLP(
                self.schema.tower_dim(tower), units, dropout, "relu",
                final_activation="linear", device=dev))
            for head in ("biz", "rel"):
                self.add_module(f"{tower}_{head}",
                                nn.Linear(out_dim, out_dim, device=dev))
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        u_in, a_in = self.embedder.tower_vectors(batch, ("user", "ad"))
        u_h, a_h = self.user_tower(u_in), self.ad_tower(a_in)
        u, a = l2_normalize(self.user_biz(u_h)), l2_normalize(self.ad_biz(a_h))
        u_rel = l2_normalize(self.user_rel(u_h))
        a_rel = l2_normalize(self.ad_rel(a_h))
        (y,) = get_labels(batch, self.schema, 1)
        if not self.training:
            return {"user": u, "ad": a, "label": y,
                    "relevance": torch.sum(u_rel * a_rel, dim=1)}
        loss_fn = self.resolve_loss()
        biz_loss, rel_loss = loss_fn(y, u, a), loss_fn(y, u_rel, a_rel)
        scores = u @ a.T                                       # [B, B]
        rel = (u_rel @ a_rel.T).detach()
        eye = torch.eye(scores.shape[0], dtype=torch.bool, device=u.device)
        hard = ~eye & (rel < self.relevance_threshold)
        mined = torch.where(hard, torch.clamp(scores, min=0.0) ** 2,
                            torch.zeros((), dtype=scores.dtype,
                                        device=scores.device))
        mobius_loss = mined.sum() / torch.clamp(hard.sum(), min=1)
        total = biz_loss + rel_loss + self.mobius_weight * mobius_loss
        return total, {"mobius_loss": mobius_loss, "rel_loss": rel_loss,
                       "hard_frac": hard.float().mean()}
