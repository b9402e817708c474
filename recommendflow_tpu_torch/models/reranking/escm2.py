"""ESCM² reranker (the counterpart of
`recommendflow_tpu/models/reranking/escm2.py`).

Entire-Space Counterfactual Multi-task model: CTR and CVR towers with a
counterfactual CVR risk by inverse-propensity-score weighting ('ips') or
doubly robust with an imputation tower ('dr'), plus the ESMM-style CTCVR
constraint. Labels: label_names[0] = click, [1] = conversion.
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
from recommendflow_tpu_torch.models.common import (bce_probs, concat_all,
                                                   get_labels, input_dim)
from recommendflow_tpu_torch.ops.mlp import MLP


class Escm2(RecModel):
    """Built as Dcn is. Training mode: (loss_ctr + ctcvr_weight *
    loss_ctcvr + cvr_weight * loss_cvr, the three parts); eval mode as
    Essm's."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None,
                 tower_units: Sequence[int] = (128, 64), dropout: float = 0.1,
                 counterfactual: str = "dr", ctcvr_weight: float = 1.0,
                 cvr_weight: float = 1.0, device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        if counterfactual not in ("ips", "dr"):
            raise ValueError(f"counterfactual {counterfactual!r}: ips or dr")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.counterfactual = counterfactual
        self.ctcvr_weight, self.cvr_weight = ctcvr_weight, cvr_weight
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev)
        width = input_dim(self.schema)
        towers = ("ctr", "cvr", "imp") if counterfactual == "dr" \
            else ("ctr", "cvr")
        for name in towers:
            self.add_module(f"{name}_tower", MLP(width, list(tower_units),
                                                 dropout, "relu", device=dev))
            self.add_module(f"{name}_head", nn.Linear(tower_units[-1], 1,
                                                      device=dev))
        init_dense_(self, gen)
        self.eval()

    def _tower(self, name: str, x: torch.Tensor) -> torch.Tensor:
        h = getattr(self, f"{name}_tower")(x)
        return getattr(self, f"{name}_head")(h)[:, 0]

    def forward(self, batch: Batch):
        schema = self.schema
        x = concat_all(self.embedder(batch), schema)
        p_ctr = torch.sigmoid(self._tower("ctr", x))
        p_cvr = torch.sigmoid(self._tower("cvr", x))
        # the imputation tower regresses BCE errors in [0, ~16]: softplus is
        # the non-negative unbounded link
        err_hat = F.softplus(self._tower("imp", x)) \
            if self.counterfactual == "dr" else None
        p_ctcvr = p_ctr * p_cvr
        y_click, y_conv = get_labels(batch, schema, 2, training=self.training)
        if not self.training:
            return {"score": p_ctcvr, "p_ctr": p_ctr, "p_cvr": p_cvr,
                    "label": y_click, "label_conv": y_conv}

        loss_ctr = torch.mean(bce_probs(y_click, p_ctr))
        loss_ctcvr = torch.mean(bce_probs(y_conv, p_ctcvr))
        # counterfactual CVR risk over the clicked subspace; the propensity
        # takes no gradient
        prop = torch.clamp(p_ctr.detach(), 0.05, 1.0)
        if self.counterfactual == "dr":
            # the DR term trains the CVR tower; only the imputation's
            # regression target is detached
            cvr_err = bce_probs(y_conv, p_cvr)
            err_target = cvr_err.detach()
            loss_imp = torch.mean((err_hat - err_target) ** 2 * y_click / prop)
            dr = err_hat + y_click / prop * (cvr_err - err_hat)
            loss_cvr = torch.mean(dr) + loss_imp
        else:
            loss_cvr = torch.mean(y_click / prop * bce_probs(y_conv, p_cvr))
        total = loss_ctr + self.ctcvr_weight * loss_ctcvr + \
            self.cvr_weight * loss_cvr
        return total, {"loss_ctr": loss_ctr, "loss_ctcvr": loss_ctcvr,
                       "loss_cvr": loss_cvr}


ESCM2 = Escm2
