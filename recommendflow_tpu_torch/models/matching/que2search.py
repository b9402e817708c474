"""Que2Search multi-channel two-tower recall model (the counterpart of
`recommendflow_tpu/models/matching/que2search.py`).

Each tower fuses several channels: a shared text encoder (`text_encoder`)
over its token features, each through an MLP `{tower}_txt{i}`, and its
sparse and dense features, each through an MLP `{tower}_ch{i}`. Two or more
channels are fused by AttentionFusion (`{tower}_fusion`); `{tower}_out`
projects to `embedding_dim`, then L2 normalisation. With a second label
column, `aux_head` predicts it from the ad vector (training adds its BCE
times Networks `aux_weight`, 0.3; eval returns `aux_score`).

Each tower embeds its own features (`embedder(batch, tower=...)`), so a step
gathers each table once per tower and its backward builds one dense table
gradient per tower: the model keeps row_injection False, as in JAX.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import (bce_with_logits,
                                                   get_labels, token_slots)
from recommendflow_tpu_torch.ops.fusion import AttentionFusion
from recommendflow_tpu_torch.ops.mlp import MLP, l2_normalize
from recommendflow_tpu_torch.ops.transformer import TextEncoder


class Que2Search(RecModel):
    """Networks keys: embedding_dim (128), channel_dim, text_vocab_size,
    text_dim (the constructor's defaults 128, 30000, 128), aux_weight.
    `text_layers` (2) and `dropout` (0.1, the channel MLPs') are
    constructor arguments only, as the JAX fields are; the text encoder
    drops by its own 0.1."""

    def __init__(self, conf: Configuration, loss=None, channel_dim: int = 128,
                 text_vocab_size: int = 30000, text_dim: int = 128,
                 text_layers: int = 2, dropout: float = 0.1, device="cuda",
                 seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        schema = self.schema
        out_dim = int(self.network_conf("embedding_dim") or 128)
        ch_dim = int(self.network_conf("channel_dim") or channel_dim)
        model_dim = int(self.network_conf("text_dim") or text_dim)
        self.embedder = FeatureEmbedder(schema, gen, device=dev)
        self.text_encoder = TextEncoder(
            int(self.network_conf("text_vocab_size") or text_vocab_size),
            num_layers=text_layers, model_dim=model_dim, pooling="cls",
            max_len=self.token_max_len(), device=dev, seed=seed)
        self.channels = {}
        for tower in ("user", "ad"):
            toks = [s.name for s in token_slots(schema, tower)]
            sparse = [s for s in schema.tower_slots(tower)
                      if s.kind in ("sparse", "dense")]
            for i, _ in enumerate(toks):
                self.add_module(f"{tower}_txt{i}", MLP(
                    model_dim, [ch_dim], dropout, "relu", device=dev))
            for i, s in enumerate(sparse):
                self.add_module(f"{tower}_ch{i}", MLP(
                    s.out_dim, [ch_dim], dropout, "relu", device=dev))
            n = len(toks) + len(sparse)
            if not n:
                raise ValueError(f"tower '{tower}' has no channels")
            if n > 1:
                self.add_module(f"{tower}_fusion",
                                AttentionFusion(n, ch_dim, device=dev))
            self.add_module(f"{tower}_out", nn.Linear(ch_dim, out_dim,
                                                      device=dev))
            self.channels[tower] = (toks, [s.name for s in sparse])
        if len(schema.label_names) > 1:
            self.aux_head = nn.Linear(out_dim, 1, device=dev)
        init_dense_(self, gen)
        self.eval()

    def _tower(self, batch: Batch, tower: str) -> torch.Tensor:
        toks, sparse = self.channels[tower]
        feats = self.embedder(batch, tower=tower)
        channels: List[torch.Tensor] = []
        for i, name in enumerate(toks):
            enc = self.text_encoder(batch[name], batch.get(f"{name}:seg"))
            channels.append(getattr(self, f"{tower}_txt{i}")(enc))
        for i, name in enumerate(sparse):
            channels.append(getattr(self, f"{tower}_ch{i}")(feats[name]))
        fused = channels[0] if len(channels) == 1 else \
            getattr(self, f"{tower}_fusion")(channels)
        return l2_normalize(getattr(self, f"{tower}_out")(fused))

    def forward(self, batch: Batch):
        schema = self.schema
        u, a = self._tower(batch, "user"), self._tower(batch, "ad")
        (y,) = get_labels(batch, schema, 1)
        aux_logit = self.aux_head(a)[:, 0] if hasattr(self, "aux_head") \
            else None
        if self.training:
            loss = self.resolve_loss()(y, u, a)
            aux = {"pos_cos": torch.sum(torch.sum(u * a, dim=1) * y)
                   / torch.clamp(torch.sum(y), min=1.0)}
            y_aux = batch.get(schema.label_names[1]) \
                if aux_logit is not None else None
            if y_aux is not None:
                aux_w = float(self.network_conf("aux_weight") or 0.3)
                aux["aux_loss"] = bce_with_logits(y_aux, aux_logit)
                loss = loss + aux_w * aux["aux_loss"]
            return loss, aux
        out = {"user": u, "ad": a, "label": y}
        if aux_logit is not None:
            out["aux_score"] = torch.sigmoid(aux_logit)
        return out
