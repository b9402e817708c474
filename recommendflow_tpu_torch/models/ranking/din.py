"""DIN ranker: candidate-conditioned attention over the user's behavior
sequence (the counterpart of `recommendflow_tpu/models/ranking/din.py`).

Config (Networks): din_sequence (the behavior feature, `pooling: null`),
din_candidate (the candidate item feature, the same embedding dim),
att_units (default [64, 32]), hidden_units (default [256, 128]).

Per position t the attention weight is MLP_dice([e_t, v_c, e_t - v_c,
e_t * v_c]) (`att{i}` Dense, `dice{i}` Dice, `att_out`); the interest is
the UNNORMALISED weighted sum of the sequence, pad positions weighing 0.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import (bce_with_logits,
                                                   get_labels)
from recommendflow_tpu_torch.ops.mlp import MLP, Dice

_POOLED_KINDS = ("sparse", "dense", "embedding")   # what embed_batch returns


class Din(RecModel):
    """Built as Dcn is; the same outputs. Dice's BatchNorm statistics are
    buffers: batch statistics in training mode, running ones in eval."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None,
                 hidden_units: Optional[Sequence[int]] = None,
                 att_units: Optional[Sequence[int]] = None,
                 dropout: float = 0.2, device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        schema = self.schema
        self.seq_name = self.network_conf("din_sequence")
        self.cand_name = self.network_conf("din_candidate")
        if not self.seq_name or not self.cand_name:
            raise ValueError("Din needs Networks.din_sequence and "
                             "Networks.din_candidate feature names")
        seq, cand = schema.slots[self.seq_name], schema.slots[self.cand_name]
        if seq.pooling.value != "null":
            raise ValueError(
                f"Din sequence feature '{self.seq_name}' must use pooling: "
                "null (the model pools it with candidate-aware attention)")
        if seq.dim != cand.dim:
            raise ValueError("Din sequence and candidate features need the "
                             f"same embedding dim ({seq.dim} vs {cand.dim})")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.embedder = FeatureEmbedder(schema, gen, device=dev)
        width = seq.num_hashes * seq.dim                  # H*D per position
        if cand.out_dim != width:
            self.cand_proj = nn.Linear(cand.out_dim, width, device=dev)
        self.att_units = list(att_units or self.network_conf("att_units")
                              or [64, 32])
        fan_in = 4 * width
        for i, units in enumerate(self.att_units):
            self.add_module(f"att{i}", nn.Linear(fan_in, units, device=dev))
            self.add_module(f"dice{i}", Dice(units, device=dev))
            fan_in = units
        self.att_out = nn.Linear(fan_in, 1, device=dev)
        other = sum(schema.slots[n].out_dim for n in schema.order
                    if schema.slots[n].kind in _POOLED_KINDS
                    and n != self.seq_name)
        units = list(hidden_units or self.network_conf("hidden_units")
                     or [256, 128])
        self.deep = MLP(other + width, units, dropout, "relu", device=dev)
        self.head = nn.Linear(units[-1], 1, device=dev)
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        schema = self.schema
        slot = schema.slots[self.seq_name]
        feats = self.embedder(batch)
        h, length, d = slot.num_hashes, slot.max_len, slot.dim
        b = feats[self.seq_name].shape[0]
        # null-pooled [B, H*L*D] -> per-position channels [B, L, H*D]
        seq = feats[self.seq_name].reshape(b, h, length, d).transpose(1, 2)
        seq = seq.reshape(b, length, h * d)
        mask = (batch[self.seq_name] > 0).any(dim=1)             # [B, L]
        cand = feats[self.cand_name].reshape(b, -1)
        if hasattr(self, "cand_proj"):
            cand = self.cand_proj(cand)
        c = cand[:, None, :].expand_as(seq)
        x = torch.cat([seq, c, seq - c, seq * c], dim=-1)
        for i in range(len(self.att_units)):
            x = getattr(self, f"dice{i}")(getattr(self, f"att{i}")(x))
        w = self.att_out(x)[..., 0].masked_fill(~mask, 0.0)      # [B, L]
        interest = torch.einsum("bl,bld->bd", w, seq)
        other = [feats[n] for n in schema.order
                 if n in feats and n != self.seq_name]
        logit = self.head(self.deep(torch.cat(other + [interest], dim=-1)))[:, 0]
        (y,) = get_labels(batch, schema, 1)
        if self.training:
            return bce_with_logits(y, logit), {
                "pred_mean": torch.mean(torch.sigmoid(logit))}
        return {"score": torch.sigmoid(logit), "logit": logit, "label": y}


DIN = Din
