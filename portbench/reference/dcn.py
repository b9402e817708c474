"""The plain Deep & Cross Network (Wang et al., ADKDD 2017): the input x0
is every feature's pooled embedding and the dense fields side by side; the
cross network x_{l+1} = x0 * (x_l · w_l) + b_l + x_l and the deep network
[dense -> relu -> dropout] per layer run beside each other, and one linear
head reads both. Training loss: binary cross-entropy on the logit,
averaged over the rows.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from portbench.reference.common import Precision, concat, dropout
from portbench.reference.layout import Layout


def param_specs(layout: Layout, args: Mapping) -> List[Tuple[str, Tuple[int, ...], str]]:
    width = layout.input_width()
    specs = []
    for i in range(args["cross_layers"]):
        specs.append((f"cross{i}.weight", (width, 1), "cross_weight"))
        specs.append((f"cross{i}.bias", (width,), "bias"))
    w = width
    for i, units in enumerate(args["hidden_units"]):
        specs.append((f"deep{i}.weight", (units, w), "weight"))
        specs.append((f"deep{i}.bias", (units,), "bias"))
        w = units
    specs.append(("head.weight", (1, width + w), "weight"))
    specs.append(("head.bias", (1,), "bias"))
    return specs


def logits(p, features: Mapping[str, torch.Tensor], layout: Layout,
           args: Mapping, training: bool, prec: Precision) -> torch.Tensor:
    x0 = concat(features, [f["name"] for f in layout.features])
    x = x0
    for i in range(args["cross_layers"]):
        x = x0 * prec.mm(x, p[f"cross{i}.weight"]) + p[f"cross{i}.bias"] + x
    h = x0
    for i in range(len(args["hidden_units"])):
        h = torch.relu(prec.linear(h, p[f"deep{i}.weight"], p[f"deep{i}.bias"]))
        h = dropout(h, args["dropout"], training)
    return prec.linear(torch.cat([x, h], dim=-1), p["head.weight"],
                       p["head.bias"])[:, 0]


def vectors(p, features, layout: Layout, args: Mapping, training: bool,
            prec: Precision) -> Dict[str, torch.Tensor]:
    return {"logit": logits(p, features, layout, args, training, prec)}


def loss(p, features, batch, layout: Layout, args: Mapping,
         prec: Precision) -> torch.Tensor:
    z = logits(p, features, layout, args, True, prec)
    y = batch[layout.labels[0]].float()
    return torch.mean(torch.clamp(z, min=0) - z * y +
                      torch.log1p(torch.exp(-torch.abs(z))))


def forward_flops(layout: Layout, args: Mapping, rows: int,
                  training: bool) -> float:
    """Multiply-adds x 2 of the deep layers and the head, and per cross
    layer the product x·w and the update x0 * s + x (4 per element)."""
    width = layout.input_width()
    flops = 4.0 * rows * width * args["cross_layers"]
    w = width
    for units in args["hidden_units"]:
        flops += 2.0 * rows * w * units
        w = units
    return flops + 2.0 * rows * (width + w)
