"""Siamese text-encoder two-tower, the siamese_bert replacement (the
counterpart of `recommendflow_tpu/models/matching/siamese_encoder.py`).

ONE shared `TextEncoder` (`encoder`) encodes every token feature of both
towers; a tower with several text inputs merges them by Networks
`embedding_pooling` (dense: concat | sum | mean | attention:
AttentionFusion `{tower}_fusion`), then `{tower}_proj` projects to
`embedding_dim` and the vectors are L2-normalised. With
`Networks.pretrained.encoder` set, the encoder is sized from that
`bert_config.json` and the trainer grafts the checkpoint into it
(encoder/pretrained.py:apply_pretrained).
"""
from __future__ import annotations

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import Batch, RecModel, init_dense_
from recommendflow_tpu_torch.models.common import (get_labels,
                                                   text_encoder_kwargs,
                                                   token_slots)
from recommendflow_tpu_torch.ops.fusion import AttentionFusion
from recommendflow_tpu_torch.ops.mlp import l2_normalize
from recommendflow_tpu_torch.ops.transformer import TextEncoder

MERGES = ("dense", "sum", "mean", "attention")


class SiameseEncoder(RecModel):
    """Networks keys: embedding_dim (128), embedding_pooling (dense),
    text_vocab_size (30000), text_dim (256), text_layers (4), text_pooling
    (cls), pretrained.encoder. In training mode the forward returns (loss,
    {'pos_cos'}), in eval mode {'user', 'ad', 'label'}.

    The encoder drops at its own rate (0.1, or the checkpoint config's
    hidden_dropout_prob), as in the JAX model, whose `dropout` field
    nothing reads. Built on `device` (default "cuda"; raises without a card
    unless "cpu" is asked for) from `seed`; starts in eval mode."""

    def __init__(self, conf: Configuration, loss=None, device="cuda",
                 seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        out_dim = int(self.network_conf("embedding_dim") or 128)
        self.merge = str(self.network_conf("embedding_pooling") or "dense")
        if self.merge not in MERGES:
            raise ValueError(f"embedding_pooling '{self.merge}': one of {MERGES}")
        self.encoder = TextEncoder(**text_encoder_kwargs(
            self, "encoder", str(self.network_conf("text_pooling") or "cls"),
            vocab_size=int(self.network_conf("text_vocab_size") or 30000),
            num_layers=int(self.network_conf("text_layers") or 4),
            model_dim=int(self.network_conf("text_dim") or 256)),
            device=dev, seed=seed)
        width = self.encoder.model_dim
        self.texts = {}
        for tower in ("user", "ad"):
            names = [s.name for s in token_slots(self.schema, tower)]
            if not names:
                raise ValueError(f"tower '{tower}' has no token_id features")
            self.texts[tower] = names
            merged = width * len(names) if (self.merge == "dense"
                                            and len(names) > 1) else width
            if self.merge == "attention" and len(names) > 1:
                self.add_module(f"{tower}_fusion",
                                AttentionFusion(len(names), width, device=dev))
            self.add_module(f"{tower}_proj",
                            nn.Linear(merged, out_dim, device=dev))
        init_dense_(self, gen)
        self.eval()

    def _tower(self, batch: Batch, tower: str) -> torch.Tensor:
        encs = [self.encoder(batch[n], batch.get(f"{n}:seg"))
                for n in self.texts[tower]]
        if len(encs) == 1:
            merged = encs[0]
        elif self.merge == "sum":
            merged = sum(encs)
        elif self.merge == "mean":
            merged = sum(encs) / len(encs)
        elif self.merge == "attention":
            merged = getattr(self, f"{tower}_fusion")(encs)
        else:
            merged = torch.cat(encs, dim=-1)
        return l2_normalize(getattr(self, f"{tower}_proj")(merged))

    def forward(self, batch: Batch):
        u, a = self._tower(batch, "user"), self._tower(batch, "ad")
        (y,) = get_labels(batch, self.schema, 1)
        if self.training:
            return self.resolve_loss()(y, u, a), {
                "pos_cos": torch.mean(torch.sum(u * a, dim=1) * y)}
        return {"user": u, "ad": a, "label": y}


BertModel = SiameseEncoder   # the reference's class name (siamese_bert)
