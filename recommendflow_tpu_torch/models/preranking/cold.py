"""COLD preranker (the counterpart of
`recommendflow_tpu/models/preranking/cold.py`).

Squeeze-excitation gating over field embeddings (the mechanism COLD uses
for offline feature selection) and a small MLP head. The learned gate
weights come out at predict time ('feature_gates'), so operators can prune
features to meet a latency budget.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import (bce_with_logits,
                                                   field_shape, field_stack,
                                                   get_labels)
from recommendflow_tpu_torch.ops.mlp import MLP


class Cold(RecModel):
    """Built as Dcn is. Training mode: (BCE loss, {'gate_mean'}); eval
    mode: {'score', 'label', 'feature_gates' (the batch's mean gate per
    field)}."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None,
                 hidden_units: Sequence[int] = (128, 64), se_reduction: int = 2,
                 dropout: float = 0.1, device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev)
        n_fields, dim = field_shape(self.schema)
        squeeze = max(n_fields // se_reduction, 1)
        self.se1 = nn.Linear(n_fields, squeeze, device=dev)
        self.se2 = nn.Linear(squeeze, n_fields, device=dev)
        dense = sum(s.out_dim for s in self.schema.dense_slots())
        self.mlp = MLP(n_fields * dim + dense, list(hidden_units), dropout,
                       "relu", device=dev)
        self.head = nn.Linear(hidden_units[-1], 1, device=dev)
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        schema = self.schema
        feats = self.embedder(batch)
        fields, _ = field_stack(feats, schema)              # [B, F, D]
        b, f, d = fields.shape
        z = torch.mean(fields, dim=-1)                      # [B, F]
        gate = torch.sigmoid(self.se2(F.relu(self.se1(z))))
        x = (fields * gate[..., None]).reshape(b, f * d)
        dense = [feats[s.name] for s in schema.dense_slots() if s.name in feats]
        if dense:
            x = torch.cat([x] + dense, dim=-1)
        logit = self.head(self.mlp(x))[:, 0]
        (y,) = get_labels(batch, schema, 1)
        if self.training:
            return bce_with_logits(y, logit), {"gate_mean": torch.mean(gate)}
        return {"score": torch.sigmoid(logit), "label": y,
                "feature_gates": torch.mean(gate, dim=0)}


COLD = Cold
