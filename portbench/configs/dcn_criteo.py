"""dcn_criteo: the program's Dcn built from this configuration's file, and
where each of the benchmark's parameters goes in it (reference name -> the
program's parameter)."""
from __future__ import annotations

from typing import Mapping

import torch

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.models.ranking.dcn import Dcn


def build_model(config: Mapping, device: torch.device, seed: int) -> torch.nn.Module:
    args = config["model_args"]
    return Dcn(Configuration(conf=config["port_conf"]),
               cross_layers=args["cross_layers"],
               hidden_units=args["hidden_units"], dropout=args["dropout"],
               device=device, seed=seed)


def port_name(name: str) -> str:
    layer, part = name.split(".")
    if layer.startswith("cross"):
        return f"cross.{'w' if part == 'weight' else 'b'}{layer[5:]}"
    if layer.startswith("deep"):
        return f"deep.Dense_{layer[4:]}.{part}"
    return name


def table_name(dim: int) -> str:
    return f"embedder.table_dim{dim}"
