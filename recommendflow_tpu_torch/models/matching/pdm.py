"""PDM, a sequence-aware two-tower (the counterpart of
`recommendflow_tpu/models/matching/pdm.py`).

The user tower attention-pools each of its behaviour sequences (the user
tower's sparse slots longer than one id) with a SelfAttention
`attn_{slot}` over the slot's raw per-position embeddings [B, L, H·D] (key
mask: a position is valid where any hash branch's id is not 0); the
attention reaches flash_attention as [B, 1, L, H·D]. Every other slot comes
from one embed pass that excludes the sequences, so each sequence's rows
are gathered once (`FeatureEmbedder.unpooled`). Towers `user_tower` /
`ad_tower` (MLP tower_units + [embedding_dim], last layer linear), then L2
normalisation. The unpooled gathers are table reads outside the embed pass,
so row_injection stays False, as in JAX.
"""
from __future__ import annotations

from typing import Sequence

import torch

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import get_labels
from recommendflow_tpu_torch.ops.attention import SelfAttention
from recommendflow_tpu_torch.ops.embedding import concat_tower
from recommendflow_tpu_torch.ops.mlp import MLP, l2_normalize


class Pdm(RecModel):
    """Networks key: embedding_dim (128); `tower_units` and `dropout` are
    constructor arguments, as the JAX fields are. Outputs as Dssm's."""

    def __init__(self, conf: Configuration, loss=None,
                 tower_units: Sequence[int] = (256, 128),
                 dropout: float = 0.1, device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        schema = self.schema
        units = list(tower_units) + [int(self.network_conf("embedding_dim")
                                         or 128)]
        self.embedder = FeatureEmbedder(schema, gen, device=dev)
        self.seq_names = [s.name for s in schema.tower_slots("user")
                          if s.kind == "sparse" and s.max_len > 1]
        user_width = 0
        for s in schema.tower_slots("user"):
            if s.name in self.seq_names:
                width = s.num_hashes * s.dim
                self.add_module(f"attn_{s.name}", SelfAttention(width,
                                                                device=dev))
                user_width += width
            elif s.kind not in ("token", "bert"):
                user_width += s.out_dim
        self.user_tower = MLP(user_width, units, dropout, "relu",
                              final_activation="linear", device=dev)
        self.ad_tower = MLP(schema.tower_dim("ad"), units, dropout, "relu",
                            final_activation="linear", device=dev)
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        schema = self.schema
        feats = self.embedder(batch, exclude=self.seq_names)
        seq_vecs = []
        for name in self.seq_names:
            emb = self.embedder.unpooled(batch, name)          # [B, H, L, D]
            b, h, l, d = emb.shape
            emb = emb.transpose(1, 2).reshape(b, l, h * d)
            mask = (batch[name] > 0).any(dim=1)                # [B, L]
            seq_vecs.append(getattr(self, f"attn_{name}")(emb, mask))
        flat = [feats[s.name] for s in schema.tower_slots("user")
                if s.name in feats]
        u = l2_normalize(self.user_tower(torch.cat(flat + seq_vecs, dim=-1)))
        a = l2_normalize(self.ad_tower(concat_tower(feats, schema, "ad")))
        (y,) = get_labels(batch, schema, 1)
        if self.training:
            return self.resolve_loss()(y, u, a), {
                "pos_cos": torch.sum(torch.sum(u * a, dim=1) * y)
                / torch.clamp(torch.sum(y), min=1.0)}
        return {"user": u, "ad": a, "label": y}
