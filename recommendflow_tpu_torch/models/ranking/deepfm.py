"""DeepFM ranker: FM over field embeddings plus a deep tower, and XDeepFm
with a CIN beside them (the counterpart of
`recommendflow_tpu/models/ranking/deepfm.py`)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import (bce_with_logits,
                                                   concat_all, field_shape,
                                                   field_stack, get_labels,
                                                   input_dim)
from recommendflow_tpu_torch.ops.interactions import CIN, FM
from recommendflow_tpu_torch.ops.mlp import MLP


class DeepFm(RecModel):
    """Built as Dcn is; the same outputs. use_cin=True adds xDeepFM's CIN
    over the same fields."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None,
                 hidden_units: Optional[Sequence[int]] = None,
                 dropout: float = 0.2, use_cin: bool = False,
                 cin_layers: Sequence[int] = (64, 64), device="cuda",
                 seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev)
        n_fields, dim = field_shape(self.schema)
        units = list(hidden_units or self.network_conf("hidden_units")
                     or [256, 128])
        self.fm = FM(n_fields, dim, device=dev)
        self.deep = MLP(input_dim(self.schema), units, dropout, "relu",
                        device=dev)
        self.deep_head = nn.Linear(units[-1], 1, device=dev)
        self.use_cin = use_cin
        if use_cin:
            self.cin = CIN(n_fields, tuple(cin_layers), generator=gen,
                           device=dev)
            self.cin_head = nn.Linear(self.cin.out_dim, 1, device=dev)
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        schema = self.schema
        feats = self.embedder(batch)
        fields, _ = field_stack(feats, schema)
        deep = self.deep(concat_all(feats, schema))
        logit = self.fm(fields) + self.deep_head(deep)[:, 0]
        if self.use_cin:
            logit = logit + self.cin_head(self.cin(fields))[:, 0]
        (y,) = get_labels(batch, schema, 1)
        if self.training:
            return bce_with_logits(y, logit), {
                "pred_mean": torch.mean(torch.sigmoid(logit))}
        return {"score": torch.sigmoid(logit), "logit": logit, "label": y}


DeepFM = DeepFm


class XDeepFm(DeepFm):
    def __init__(self, conf: Configuration, loss=None, use_cin: bool = True,
                 **kwargs):
        super().__init__(conf, loss, use_cin=use_cin, **kwargs)


XDeepFM = XDeepFm
