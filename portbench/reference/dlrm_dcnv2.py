"""The plain DLRM-DCNv2 (MLPerf Training's recommendation model: torchrec's
DLRM_DCN in mlcommons/training recommendation_v2/torchrec_dlrm): the dense
fields through a bottom MLP (ReLU after every layer); x0 the bottom output
and every sparse feature's pooled embedding side by side, in the
configuration's order; the low-rank cross (Wang et al., DCN V2, arXiv
2008.13535) x_{l+1} = x0 * (U_l (V_l x_l) + b_l) + x_l; a top MLP (ReLU
after every layer) and a linear head to one logit. Training loss: binary
cross-entropy on the logit, averaged over the rows.

Departures from the source, each the configuration's (`assumed`): the
tables in bfloat16 where the source holds float32, row 0 of each field a
pad left out of its bag's sum, row-wise Adagrad on the tables and Adam on
the dense layers (common.py) where the source runs Adagrad on both, the
dense fields as generated (no log transform).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch

from portbench.reference.common import Precision, concat
from portbench.reference.layout import Layout


def _widths(layout: Layout, args: Mapping) -> Tuple[int, int]:
    """(the dense fields' width, x0's width)."""
    dense = sum(layout.width(f) for f in layout.features if f["kind"] == "dense")
    sparse = sum(layout.width(f) for f in layout.sparse())
    return dense, args["bottom_units"][-1] + sparse


def param_specs(layout: Layout, args: Mapping) -> List[Tuple[str, Tuple[int, ...], str]]:
    w_in, width = _widths(layout, args)
    specs = []
    for arch, units in (("bottom", args["bottom_units"]), ("top", args["top_units"])):
        w = w_in if arch == "bottom" else width
        for i, u in enumerate(units):
            specs.append((f"{arch}{i}.weight", (u, w), "weight"))
            specs.append((f"{arch}{i}.bias", (u,), "bias"))
            w = u
        if arch == "bottom":
            for i in range(args["cross_layers"]):
                specs.append((f"cross{i}.V", (args["low_rank"], width), "weight"))
                specs.append((f"cross{i}.U", (width, args["low_rank"]), "weight"))
                specs.append((f"cross{i}.bias", (width,), "bias"))
    specs.append(("head.weight", (1, args["top_units"][-1]), "weight"))
    specs.append(("head.bias", (1,), "bias"))
    return specs


def logits(p, features: Mapping[str, torch.Tensor], layout: Layout,
           args: Mapping, training: bool, prec: Precision) -> torch.Tensor:
    h = concat(features, [f["name"] for f in layout.features if f["kind"] == "dense"])
    for i in range(len(args["bottom_units"])):
        h = torch.relu(prec.linear(h, p[f"bottom{i}.weight"], p[f"bottom{i}.bias"]))
    x0 = torch.cat([h, concat(features, [f["name"] for f in layout.sparse()])], dim=-1)
    x = x0
    for i in range(args["cross_layers"]):
        u = prec.linear(prec.mm(x, p[f"cross{i}.V"].t()), p[f"cross{i}.U"],
                        p[f"cross{i}.bias"])
        x = x0 * u + x
    for i in range(len(args["top_units"])):
        x = torch.relu(prec.linear(x, p[f"top{i}.weight"], p[f"top{i}.bias"]))
    return prec.linear(x, p["head.weight"], p["head.bias"])[:, 0]


def vectors(p, features, layout: Layout, args: Mapping, training: bool,
            prec: Precision) -> Dict[str, torch.Tensor]:
    return {"logit": logits(p, features, layout, args, training, prec)}


def loss(p, features, batch, layout: Layout, args: Mapping,
         prec: Precision) -> torch.Tensor:
    z = logits(p, features, layout, args, True, prec)
    y = batch[layout.labels[0]].float()
    return torch.mean(torch.clamp(z, min=0) - z * y +
                      torch.log1p(torch.exp(-torch.abs(z))))


def interaction_flops(layout: Layout, args: Mapping, rows: int) -> float:
    """The low-rank cross's forward: per layer the two products (2 x rows x
    width x rank each) and x0 * (u + b) + x (3 per element)."""
    _, width = _widths(layout, args)
    return float(args["cross_layers"]) * rows * width * (4.0 * args["low_rank"] + 3.0)


def forward_flops(layout: Layout, args: Mapping, rows: int,
                  training: bool) -> float:
    """Multiply-adds x 2 of the bottom MLP, the top MLP and the head, and
    the cross (`interaction_flops`)."""
    w_in, width = _widths(layout, args)
    flops = interaction_flops(layout, args, rows)
    for w, units in ((w_in, args["bottom_units"]), (width, args["top_units"] + [1])):
        for u in units:
            flops += 2.0 * rows * w * u
            w = u
    return flops
