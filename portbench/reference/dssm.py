"""The plain two-tower DSSM (Huang et al., CIKM 2013, as the repository's
recall model runs it): per tower, the tower's pooled features side by side,
then [BatchNorm -> dense -> selu -> dropout] per layer with a linear last
layer, then L2 normalisation. Training loss: the in-batch softmax of
scale * u·a over the batch's items, at each row's own item, weighted by the
row's label, averaged over the rows.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import (Precision, batch_norm, concat,
                                        dropout, l2_normalize)
from portbench.reference.layout import Layout

TOWERS = ("user", "ad")


def param_specs(layout: Layout, args: Mapping) -> List[Tuple[str, Tuple[int, ...], str]]:
    specs = []
    for tower in TOWERS:
        width = layout.tower_width(tower)
        for i, units in enumerate(args["tower_units"]):
            if args["batch_norm"]:
                for part, kind in (("scale", "bn_scale"), ("shift", "bn_shift"),
                                   ("mean", "bn_mean"), ("var", "bn_var")):
                    specs.append((f"{tower}.bn{i}.{part}", (width,), kind))
            specs.append((f"{tower}.dense{i}.weight", (units, width), "weight"))
            specs.append((f"{tower}.dense{i}.bias", (units,), "bias"))
            width = units
    return specs


def tower(p: Mapping[str, torch.Tensor], x: torch.Tensor, name: str,
          args: Mapping, training: bool, prec: Precision) -> torch.Tensor:
    n = len(args["tower_units"])
    for i in range(n):
        if args["batch_norm"]:
            x = batch_norm(x, p, f"{name}.bn{i}", training, args["bn_eps"])
        x = prec.linear(x, p[f"{name}.dense{i}.weight"], p[f"{name}.dense{i}.bias"])
        if i < n - 1:
            x = F.selu(x)
        x = dropout(x, args["dropout"], training)
    return l2_normalize(x)


def vectors(p, features: Mapping[str, torch.Tensor], layout: Layout,
            args: Mapping, training: bool, prec: Precision
            ) -> Dict[str, torch.Tensor]:
    """{'user': [B, D], 'ad': [B, D]}, the user tower first (its dropout
    draws come first)."""
    return {t: tower(p, concat(features, [f["name"] for f in layout.tower(t)]),
                     t, args, training, prec) for t in TOWERS}


def loss(p, features, batch, layout: Layout, args: Mapping,
         prec: Precision) -> torch.Tensor:
    v = vectors(p, features, layout, args, True, prec)
    u, a = v["user"], v["ad"]
    logp = torch.log_softmax(args["loss_scale"] * prec.mm(u, a.t()), dim=-1)
    y = batch[layout.labels[0]].float()
    return torch.mean(-torch.diagonal(logp) * y)


def forward_flops(layout: Layout, args: Mapping, rows: int,
                  training: bool) -> float:
    """Multiply-adds x 2 of both towers' dense layers on `rows` rows, and
    in training the in-batch score matrix."""
    flops = 0.0
    for t in TOWERS:
        width = layout.tower_width(t)
        for units in args["tower_units"]:
            flops += 2.0 * rows * width * units
            width = units
    if training:
        flops += 2.0 * rows * rows * args["tower_units"][-1]
    return flops
