"""DSSM / two-tower recall model, inference (the counterpart of
`recommendflow_tpu/models/matching/dssm.py`).

Per-tower feature embedding -> MLP tower (selu + BatchNorm by default) -> L2
normalize; in eval mode the forward returns {'user', 'ad', 'label', ...},
which feeds the retrieval evaluator directly. Both towers' features come from
one fused gather per dim group (FeatureEmbedder.tower_vectors).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.ops.mlp import MLP, l2_normalize


class Dssm(RecModel):
    """Two-tower DSSM. Networks config keys: tower_units (default
    [1024, 512, 256]), dropout, activation, embedding_dim (final projection
    width, 0 = last tower unit).

    Built on `device` (default "cuda"; raises without a card unless "cpu" is
    asked for) with weights drawn from a torch.Generator seeded by `seed`.
    The module starts in eval mode: only the inference forward exists yet."""

    def __init__(self, conf: Configuration, loss=None,
                 tower_units: Optional[Sequence[int]] = None,
                 dropout: float = 0.3, activation: str = "selu",
                 use_bn: bool = True, device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.tower_units = tower_units
        units = self._units()
        compute_dtype = self.network_conf("compute_dtype")
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev)
        self.user_tower = MLP(self.schema.tower_dim("user"), units, dropout,
                              activation, use_bn=use_bn,
                              final_activation="linear",
                              compute_dtype=compute_dtype, device=dev)
        self.ad_tower = MLP(self.schema.tower_dim("ad"), units, dropout,
                            activation, use_bn=use_bn,
                            final_activation="linear",
                            compute_dtype=compute_dtype, device=dev)
        init_dense_(self, gen)
        self.eval()

    def _units(self) -> Sequence[int]:
        units = self.tower_units or self.network_conf("tower_units") or [1024, 512, 256]
        out_dim = int(self.network_conf("embedding_dim") or 0)
        units = list(units)
        if out_dim and units[-1] != out_dim:
            units.append(out_dim)
        return units

    def forward(self, batch: Batch) -> Dict[str, torch.Tensor]:
        if self.training:
            raise NotImplementedError(
                "the training forward (in-batch loss) arrives with the "
                "training slice; call model.eval() for inference")
        schema = self.schema
        user_in, ad_in = self.embedder.tower_vectors(batch, ("user", "ad"))
        u = l2_normalize(self.user_tower(user_in))
        a = l2_normalize(self.ad_tower(ad_in))
        label_name = schema.label_names[0] if schema.label_names else "label"
        y_true = batch.get(label_name)
        if y_true is None:
            y_true = torch.ones(u.shape[0], dtype=u.dtype, device=u.device)
        out: Dict[str, torch.Tensor] = {"user": u, "ad": a, "label": y_true}
        # pass through any extra label-tower ids
        for name in schema.label_names[1:]:
            if name in batch:
                out[name] = batch[name]
        return out


class TwoTower(Dssm):
    """Alias with a neutral name for non-ad domains."""
