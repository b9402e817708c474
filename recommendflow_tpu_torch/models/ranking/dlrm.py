"""DLRM-DCNv2 ranker (MLPerf Training's recommendation model since v3.0:
torchrec's `DLRM_DCN`): the dense fields through a bottom MLP, beside them
every sparse field's pooled embedding, their concatenation x0 through a
low-rank DCN-V2 cross (`ops/interactions.py:LowRankCrossNet`), then a top
MLP and a linear head to one logit. No counterpart in the JAX package."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import bce_with_logits, get_labels
from recommendflow_tpu_torch.ops.interactions import LowRankCrossNet
from recommendflow_tpu_torch.ops.mlp import MLP
from recommendflow_tpu_torch.parallel.mesh import Mesh
from recommendflow_tpu_torch.utils.profiling import span


class DlrmDcnV2(RecModel):
    """Built on `device` (default "cuda"; raises without a card unless "cpu"
    is asked for) with weights drawn from a torch.Generator seeded by
    `seed`. The arguments default to `Networks.bottom_units`,
    `cross_layers`, `low_rank` and `top_units`, else MLPerf's widths. The
    bottom MLP ([dense slots] -> bottom_units, ReLU after each layer) must
    end at the sparse fields' width for x0 = [bottom, the pooled sparse
    fields in schema order]; the top MLP is ReLU throughout, the head
    linear. Training mode: (BCE loss, {'pred_mean'}); eval mode: {'score',
    'logit', 'label'}. With a `mesh`, the tables that
    `Trainer(mesh=mesh, shard_tables=True)` row-shards are made as this
    rank's block alone (`FeatureEmbedder`). Host spans `dlrm.bottom`,
    `dlrm.interaction`, `dlrm.top` (`utils/profiling.py:span`)."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None,
                 bottom_units: Optional[Sequence[int]] = None,
                 cross_layers: Optional[int] = None,
                 low_rank: Optional[int] = None,
                 top_units: Optional[Sequence[int]] = None,
                 device="cuda", seed: int = 0, mesh: Optional[Mesh] = None):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev, mesh=mesh)
        bottom = list(bottom_units or self.network_conf("bottom_units")
                      or [512, 256, 128])
        top = list(top_units or self.network_conf("top_units")
                   or [1024, 1024, 512, 256])
        layers = int(cross_layers or self.network_conf("cross_layers") or 3)
        rank = int(low_rank or self.network_conf("low_rank") or 512)
        dense_in = sum(s.out_dim for s in self.schema.dense_slots())
        sparse_out = [s.out_dim for s in self.schema.sparse_slots()]
        if not dense_in or not sparse_out:
            raise ValueError("DlrmDcnV2 needs dense and sparse slots")
        if bottom[-1] != sparse_out[0]:
            raise ValueError(f"the bottom MLP ends at {bottom[-1]}, not at "
                             f"the sparse fields' width {sparse_out[0]}")
        width = bottom[-1] + sum(sparse_out)
        self.bottom = MLP(dense_in, bottom, 0.0, "relu", device=dev)
        self.cross = LowRankCrossNet(width, layers, rank, device=dev)
        self.top = MLP(width, top, 0.0, "relu", device=dev)
        self.head = nn.Linear(top[-1], 1, device=dev)
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        schema = self.schema
        feats = self.embedder(batch)
        with span("dlrm.bottom"):
            dense = self.bottom(torch.cat(
                [feats[s.name] for s in schema.dense_slots()], dim=-1))
        with span("dlrm.interaction"):
            x0 = torch.cat([dense] + [feats[s.name]
                                      for s in schema.sparse_slots()], dim=-1)
            x = self.cross(x0)
        with span("dlrm.top"):
            logit = self.head(self.top(x))[:, 0]
        (y,) = get_labels(batch, schema, 1)
        if self.training:
            return bce_with_logits(y, logit), {
                "pred_mean": torch.mean(torch.sigmoid(logit))}
        return {"score": torch.sigmoid(logit), "logit": logit, "label": y}
