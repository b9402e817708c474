"""DNN CTR ranker (the counterpart of
`recommendflow_tpu/models/ranking/dnn.py`)."""
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
from recommendflow_tpu_torch.ops.mlp import MLP


class Dnn(RecModel):
    """An MLP over the concat of every input feature. Built as Dcn is;
    the same outputs."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None,
                 hidden_units: Optional[Sequence[int]] = None,
                 dropout: float = 0.2, activation: str = "relu",
                 device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev)
        units = list(hidden_units or self.network_conf("hidden_units")
                     or [512, 256, 128])
        self.mlp = MLP(input_dim(self.schema), units, dropout, activation,
                       device=dev)
        self.head = nn.Linear(units[-1], 1, device=dev)
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        schema = self.schema
        h = self.mlp(concat_all(self.embedder(batch), schema))
        logit = self.head(h)[:, 0]
        (y,) = get_labels(batch, schema, 1)
        if self.training:
            return bce_with_logits(y, logit), {
                "pred_mean": torch.mean(torch.sigmoid(logit))}
        return {"score": torch.sigmoid(logit), "logit": logit, "label": y}


DNN = Dnn
