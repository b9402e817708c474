"""ESMM entire-space multi-task ranker (the counterpart of
`recommendflow_tpu/models/ranking/essm.py`).

pCTR and pCVR towers over shared embeddings; supervision on pCTR (click)
and pCTCVR = pCTR * pCVR (conversion). Labels: label_names[0] = click,
label_names[1] = conversion.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import (bce_probs, concat_all,
                                                   get_labels, input_dim)
from recommendflow_tpu_torch.ops.mlp import MLP


class Essm(RecModel):
    """Built as Dcn is. Training mode: (loss_ctr + loss_ctcvr, both);
    eval mode: {'score' (pCTCVR), 'p_ctr', 'p_cvr', 'label', 'label_conv'}."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None,
                 tower_units: Sequence[int] = (128, 64), dropout: float = 0.1,
                 device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev)
        width = input_dim(self.schema)
        for name in ("ctr", "cvr"):
            self.add_module(f"{name}_tower", MLP(width, list(tower_units),
                                                 dropout, "relu", device=dev))
            self.add_module(f"{name}_head", nn.Linear(tower_units[-1], 1,
                                                      device=dev))
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        schema = self.schema
        x = concat_all(self.embedder(batch), schema)
        p_ctr = torch.sigmoid(self.ctr_head(self.ctr_tower(x))[:, 0])
        p_cvr = torch.sigmoid(self.cvr_head(self.cvr_tower(x))[:, 0])
        p_ctcvr = p_ctr * p_cvr
        y_click, y_conv = get_labels(batch, schema, 2, training=self.training)
        if self.training:
            loss_ctr = torch.mean(bce_probs(y_click, p_ctr))
            loss_ctcvr = torch.mean(bce_probs(y_conv, p_ctcvr))
            return loss_ctr + loss_ctcvr, {"loss_ctr": loss_ctr,
                                           "loss_ctcvr": loss_ctcvr}
        return {"score": p_ctcvr, "p_ctr": p_ctr, "p_cvr": p_cvr,
                "label": y_click, "label_conv": y_conv}


ESSM = Essm
Esmm = Essm
