"""ESIM cross-attention matcher for ranking (the counterpart of
`recommendflow_tpu/models/ranking/esim.py`): encode the query and doc token
sequences, soft-align them, enhance ([x; a; x-a; x*a]) and project, compose,
avg + max pool, fuse the side features, and score with a two-class softmax
head. As in the JAX package, the BiLSTM roles are transformer encoder blocks:
`input_enc` and `compose` are each one block, shared by the query and the
doc (called once per side with that side's key mask).
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import get_labels
from recommendflow_tpu_torch.ops.attention import (esim_enhance,
                                                   soft_attention_align)
from recommendflow_tpu_torch.ops.mlp import MLP
from recommendflow_tpu_torch.ops.transformer import TransformerEncoderBlock


def masked_pools(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[masked mean; masked max] over the length axis of x [B, L, D]; a row
    with no valid position pools to 0 (not to the -1e9 fill)."""
    m = mask[..., None].to(x.dtype)
    avg = (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    any_valid = mask.any(dim=1)[..., None]
    mx = torch.where(m > 0, x, torch.full_like(x, -1e9)).amax(dim=1)
    mx = torch.where(any_valid, mx, torch.zeros_like(mx))
    return torch.cat([avg, mx], dim=-1)


class Esim(RecModel):
    """Built as Dcn is. Networks keys: query_token_feature and
    doc_token_feature (token_id features; default the first two token
    features of the schema), vocab_size. Training mode: (the two-class
    cross entropy, {'pred_mean'}); eval mode: {'score' (P(class 1)),
    'label'}. The token table `tok_emb` is a dense parameter (Adam), read
    by nn.Embedding: an id outside the vocab raises (flax's Embed fills
    NaN)."""

    row_injection = True  # single full-batch embed pass (models/base.py)

    def __init__(self, conf: Configuration, loss=None, model_dim: int = 64,
                 vocab_size: int = 30000, num_heads: int = 4,
                 mlp_units: Sequence[int] = (128, 64), dropout: float = 0.1,
                 device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        schema = self.schema
        self.token_features = self._token_features()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        vocab = int(self.network_conf("vocab_size") or vocab_size)
        self.tok_emb = nn.Embedding(vocab, model_dim, device=dev)
        self.input_enc = TransformerEncoderBlock(model_dim, num_heads,
                                                 4 * model_dim, dropout,
                                                 device=dev)
        self.proj = nn.Linear(4 * model_dim, model_dim, device=dev)
        self.proj2 = nn.Linear(4 * model_dim, model_dim, device=dev)
        self.compose = TransformerEncoderBlock(model_dim, num_heads,
                                               4 * model_dim, dropout,
                                               device=dev)
        self.embedder = FeatureEmbedder(schema, gen, device=dev)
        width = 4 * model_dim + sum(s.out_dim for s in schema.dense_slots()) \
            + sum(s.out_dim for s in schema.sparse_slots())
        self.mlp = MLP(width, list(mlp_units), dropout, "relu", device=dev)
        self.head = nn.Linear(list(mlp_units)[-1], 2, device=dev)
        init_dense_(self, gen)
        with torch.no_grad():      # flax's Embed: normal of variance 1/dim
            self.tok_emb.weight.normal_(0.0, 1.0 / math.sqrt(model_dim),
                                        generator=gen)
        self.eval()

    def _token_features(self) -> List[str]:
        q = self.network_conf("query_token_feature")
        d = self.network_conf("doc_token_feature")
        if q and d:
            return [q, d]
        schema = self.schema
        toks = [n for n in schema.order if schema.slots[n].kind == "token"]
        if len(toks) < 2:
            raise ValueError("Esim needs two token_id features (query, doc)")
        return toks[:2]

    def forward(self, batch: Batch):
        schema = self.schema
        q_ids, d_ids = (batch[n].long() for n in self.token_features)
        q_mask, d_mask = q_ids > 0, d_ids > 0
        q = self.input_enc(self.tok_emb(q_ids), q_mask)
        d = self.input_enc(self.tok_emb(d_ids), d_mask)
        q_al, d_al = soft_attention_align(q, d, q_mask, d_mask)
        q_c = self.compose(self.proj(esim_enhance(q, q_al)), q_mask)
        d_c = self.compose(self.proj2(esim_enhance(d, d_al)), d_mask)
        pooled = torch.cat([masked_pools(q_c, q_mask),
                            masked_pools(d_c, d_mask)], dim=-1)
        feats = self.embedder(batch)
        extra = [feats[s.name] for s in schema.dense_slots() if s.name in feats]
        extra += [feats[s.name] for s in schema.sparse_slots()
                  if s.name in feats]
        if extra:
            pooled = torch.cat([pooled] + extra, dim=-1)
        logits2 = self.head(self.mlp(pooled))
        (y,) = get_labels(batch, schema, 1)
        if self.training:
            logp = torch.log_softmax(logits2, dim=-1)
            loss = -torch.mean(torch.gather(logp, 1, y.long()[:, None])[:, 0])
            return loss, {"pred_mean": torch.mean(
                torch.softmax(logits2, dim=-1)[:, 1])}
        return {"score": torch.softmax(logits2, dim=-1)[:, 1], "label": y}
