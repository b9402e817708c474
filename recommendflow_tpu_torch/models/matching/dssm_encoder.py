"""Two-tower with SEPARATE query and doc text encoders, the dssm_bert
replacement (the counterpart of
`recommendflow_tpu/models/matching/dssm_encoder.py`): `user_encoder` and
`ad_encoder` each encode their tower's first token feature, `user_proj` /
`ad_proj` project to a shared `embedding_dim`, then L2 normalisation. Each
encoder is sized from `Networks.pretrained.<user|ad>_encoder`'s
bert_config.json when that is set (the trainer grafts the checkpoint).
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
from recommendflow_tpu_torch.ops.mlp import l2_normalize
from recommendflow_tpu_torch.ops.transformer import TextEncoder


class DssmEncoder(RecModel):
    """Networks keys: embedding_dim (128), user_encoder / ad_encoder
    ({vocab_size: 30000, num_layers: 4, model_dim: 256, pooling: cls}),
    pretrained.{user_encoder, ad_encoder}. Outputs as SiameseEncoder's; as
    there, the encoders drop by their own rate."""

    def __init__(self, conf: Configuration, loss=None, device="cuda",
                 seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        out_dim = int(self.network_conf("embedding_dim") or 128)
        self.text = {}
        for i, tower in enumerate(("user", "ad")):
            slots = token_slots(self.schema, tower)
            if not slots:
                raise ValueError(f"tower '{tower}' has no token_id features")
            self.text[tower] = slots[0].name
            cfg = self.network_conf(f"{tower}_encoder") or {}
            encoder = TextEncoder(**text_encoder_kwargs(
                self, f"{tower}_encoder", str(cfg.get("pooling", "cls")),
                vocab_size=int(cfg.get("vocab_size", 30000)),
                num_layers=int(cfg.get("num_layers", 4)),
                model_dim=int(cfg.get("model_dim", 256))),
                device=dev, seed=seed + i)
            self.add_module(f"{tower}_encoder", encoder)
            self.add_module(f"{tower}_proj", nn.Linear(
                encoder.model_dim, out_dim, device=dev))
        init_dense_(self, gen)
        self.eval()

    def _tower(self, batch: Batch, tower: str) -> torch.Tensor:
        name = self.text[tower]
        enc = getattr(self, f"{tower}_encoder")(batch[name],
                                                batch.get(f"{name}:seg"))
        return l2_normalize(getattr(self, f"{tower}_proj")(enc))

    def forward(self, batch: Batch):
        u, a = self._tower(batch, "user"), self._tower(batch, "ad")
        (y,) = get_labels(batch, self.schema, 1)
        if self.training:
            return self.resolve_loss()(y, u, a), {
                "pos_cos": torch.mean(torch.sum(u * a, dim=1) * y)}
        return {"user": u, "ad": a, "label": y}


BertModel = DssmEncoder   # the reference's class name (dssm_bert)
