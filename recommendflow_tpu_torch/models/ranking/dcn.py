"""DCN ranker: CrossNetwork and a deep tower in parallel (the counterpart of
`recommendflow_tpu/models/ranking/dcn.py`)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import (bce_with_logits,
                                                   concat_all, get_labels,
                                                   input_dim)
from recommendflow_tpu_torch.ops.interactions import CrossNetwork
from recommendflow_tpu_torch.ops.mlp import MLP


class Dcn(RecModel):
    """Built on `device` (default "cuda"; raises without a card unless "cpu"
    is asked for) with weights drawn from a torch.Generator seeded by
    `seed`. Training mode: (BCE loss, {'pred_mean'}); eval mode: {'score',
    'logit', 'label'}."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None, cross_layers: int = 3,
                 hidden_units: Optional[Sequence[int]] = None,
                 dropout: float = 0.2, device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev)
        width = input_dim(self.schema)
        units = list(hidden_units or self.network_conf("hidden_units")
                     or [256, 128])
        self.cross = CrossNetwork(width, cross_layers, generator=gen, device=dev)
        self.deep = MLP(width, units, dropout, "relu", device=dev)
        self.head = nn.Linear(width + units[-1], 1, device=dev)
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        schema = self.schema
        x = concat_all(self.embedder(batch), schema)
        logit = self.head(torch.cat([self.cross(x), self.deep(x)], dim=-1))[:, 0]
        (y,) = get_labels(batch, schema, 1)
        if self.training:
            return bce_with_logits(y, logit), {
                "pred_mean": torch.mean(torch.sigmoid(logit))}
        return {"score": torch.sigmoid(logit), "logit": logit, "label": y}


DCN = Dcn
