"""MMoE multi-task ranker (the counterpart of
`recommendflow_tpu/models/ranking/mmoe.py`).

Multi-gate mixture of experts: E expert MLPs shared across the tasks, run
as one batched computation over an [E, ...] parameter axis
(ops/mlp.py:ExpertsMLP), each task with its own softmax gate, tower and
head. Task labels come from the config's label features in order.

`migrate_legacy_params` turns a flax params tree written before the experts
were batched (one `expert{i}` subtree per expert) into the stacked layout;
`interop.load_jax_variables` applies it to an Mmoe's tree.
"""
from __future__ import annotations

import re
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.interop import flatten, unflatten
from recommendflow_tpu_torch.models.base import (Batch, FeatureEmbedder,
                                                 RecModel, init_dense_)
from recommendflow_tpu_torch.models.common import (bce_with_logits,
                                                   concat_all, get_labels,
                                                   input_dim)
from recommendflow_tpu_torch.ops.mlp import MLP, ExpertsMLP


def migrate_legacy_params(params: Mapping[str, Any]):
    """A pre-ExpertsMLP Mmoe params tree of numpy arrays (the JAX layout: one
    `expert{i}` MLP subtree per expert) in the stacked layout
    (`ExpertsMLP_0/experts` with a leading expert axis), as the JAX
    package's `migrate_legacy_params`. Returns `params` itself when it holds
    no `expert{i}` subtree or is stacked already."""
    d = dict(params)
    keys = sorted((k for k in d if re.fullmatch(r"expert\d+", k)),
                  key=lambda k: int(k[len("expert"):]))
    if not keys or "ExpertsMLP_0" in d:
        return params
    subtrees = [flatten(d.pop(k)) for k in keys]
    if any(sorted(t) != sorted(subtrees[0]) for t in subtrees):
        raise ValueError(f"the expert subtrees {keys} differ in structure")
    d["ExpertsMLP_0"] = {"experts": unflatten(
        {path: np.stack([np.asarray(t[path]) for t in subtrees])
         for path in subtrees[0]})}
    return d


class Mmoe(RecModel):
    """Built as Dcn is. Training mode: (the sum of the tasks' BCE losses,
    {'task{t}_loss'}); eval mode: {'score{t}', 'label{t}'} per task, with
    'score' and 'label' the first task's."""

    row_injection = True  # single full-batch embed pass (models/base.py)
    migrate_legacy_params = staticmethod(migrate_legacy_params)

    def __init__(self, conf: Configuration, loss=None, num_experts: int = 4,
                 num_tasks: int = 2, expert_units: Sequence[int] = (128, 64),
                 tower_units: Sequence[int] = (32,), dropout: float = 0.1,
                 device="cuda", seed: int = 0):
        super().__init__(conf, loss)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.num_tasks = num_tasks
        self.embedder = FeatureEmbedder(self.schema, gen, device=dev)
        width = input_dim(self.schema)
        # the flax auto-name of the JAX package's unnamed ExpertsMLP
        self.ExpertsMLP_0 = ExpertsMLP(num_experts, width, list(expert_units),
                                       dropout, "relu", device=dev)
        for t in range(num_tasks):
            self.add_module(f"gate{t}", nn.Linear(width, num_experts,
                                                  device=dev))
            self.add_module(f"tower{t}", MLP(expert_units[-1], list(tower_units),
                                             dropout, "relu", device=dev))
            self.add_module(f"head{t}", nn.Linear(tower_units[-1], 1,
                                                  device=dev))
        init_dense_(self, gen)
        self.eval()

    def forward(self, batch: Batch):
        schema = self.schema
        x = concat_all(self.embedder(batch), schema)
        experts = self.ExpertsMLP_0(x)                        # [B, E, D]
        logits = []
        for t in range(self.num_tasks):
            gate = torch.softmax(getattr(self, f"gate{t}")(x), dim=-1)
            mixed = torch.einsum("be,bed->bd", gate, experts)
            h = getattr(self, f"tower{t}")(mixed)
            logits.append(getattr(self, f"head{t}")(h)[:, 0])
        ys = get_labels(batch, schema, self.num_tasks, training=self.training)
        if self.training:
            losses = [bce_with_logits(y, l) for y, l in zip(ys, logits)]
            return sum(losses), {f"task{t}_loss": l for t, l in enumerate(losses)}
        out = {"label": ys[0]}
        for t in range(self.num_tasks):
            out[f"score{t}"] = torch.sigmoid(logits[t])
            out[f"label{t}"] = ys[t]
        out["score"] = out["score0"]
        return out


MMoE = Mmoe
