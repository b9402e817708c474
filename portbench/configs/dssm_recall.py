"""dssm_recall: the program's two-tower Dssm built from this
configuration's file, and where each of the benchmark's parameters goes in
it (reference name -> the program's parameter or buffer)."""
from __future__ import annotations

from typing import Mapping

import torch

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.models.matching.dssm import Dssm

_BN = {"scale": "weight", "shift": "bias", "mean": "running_mean",
       "var": "running_var"}


def build_model(config: Mapping, device: torch.device, seed: int) -> torch.nn.Module:
    args = config["model_args"]
    return Dssm(Configuration(conf=config["port_conf"]),
                dropout=args["dropout"], activation=args["activation"],
                use_bn=args["batch_norm"], device=device, seed=seed)


def port_name(name: str) -> str:
    tower, layer, part = name.split(".")
    i = layer[-1]
    if layer.startswith("bn"):
        return f"{tower}_tower.BatchNorm_{i}.{_BN[part]}"
    return f"{tower}_tower.Dense_{i}.{part}"


def table_name(dim: int) -> str:
    return f"embedder.table_dim{dim}"


