"""TabTransformer ranker (the counterpart of
`recommendflow_tpu/models/ranking/tabtransformer.py`): transformer blocks
over the categorical field embeddings, the dense features after them, then
an MLP and a logit head."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import (bce_with_logits,
                                                   field_shape, field_stack,
                                                   get_labels)
from recommendflow_tpu_torch.ops.mlp import MLP
from recommendflow_tpu_torch.ops.transformer import TabTransformer as TabBlocks


class TabTransformer(RecModel):
    """Built as Dcn is; the same outputs. The blocks (`tab.block{i}`) run
    over `field_stack`'s [B, F, D] with ffn_hidden 4·D and no mask, so each
    launches flash_attention at [B, num_heads, F, D / num_heads]."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None, num_blocks: int = 2,
                 num_heads: int = 4, hidden_units: Sequence[int] = (128, 64),
                 dropout: float = 0.1, device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev)
        n_fields, dim = field_shape(self.schema)
        self.tab = TabBlocks(dim, num_blocks, num_heads, ffn_hidden=4 * dim,
                             dropout=dropout, device=dev)
        width = n_fields * dim + sum(s.out_dim for s in self.schema.dense_slots())
        self.mlp = MLP(width, list(hidden_units), dropout, "relu", device=dev)
        self.head = nn.Linear(list(hidden_units)[-1], 1, device=dev)
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        schema = self.schema
        feats = self.embedder(batch)
        fields, _ = field_stack(feats, schema)
        ctx = self.tab(fields)
        dense = [feats[s.name] for s in schema.dense_slots() if s.name in feats]
        x = torch.cat([ctx] + dense, dim=-1) if dense else ctx
        logit = self.head(self.mlp(x))[:, 0]
        (y,) = get_labels(batch, schema, 1)
        if self.training:
            return bce_with_logits(y, logit), {
                "pred_mean": torch.mean(torch.sigmoid(logit))}
        return {"score": torch.sigmoid(logit), "logit": logit, "label": y}
