"""dlrm_dcnv2: the program's DlrmDcnV2 built from this configuration's
file, and where each of the benchmark's parameters goes in it (reference
name -> the program's parameter). On a mesh whose configuration says
`shard_tables`, the model is built for it (`DlrmDcnV2(mesh=)`): each table
that the ranks row-shard is made at this rank's block alone, never whole.

A rank of a mesh of several keeps one intra-op thread unless
OMP_NUM_THREADS is set, as torchrun sets it for each process it starts:
`harness/ranks.py` starts the ranks without it. With torch's thread a core
in each of four ranks on 32 cores, the batch's pinned copy took 420-495 ms
a step, against 8 ms with one thread, and the cell's rate swung between
runs."""
from __future__ import annotations

import os
from typing import Mapping

import torch

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.models.ranking.dlrm import DlrmDcnV2
from recommendflow_tpu_torch.parallel.mesh import current_mesh


def build_model(config: Mapping, device: torch.device, seed: int) -> torch.nn.Module:
    args = config["model_args"]
    mesh = current_mesh() if config.get("shard_tables") and \
        torch.distributed.is_initialized() else None
    if torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1 and \
            "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(1)
    return DlrmDcnV2(Configuration(conf=config["port_conf"]),
                     bottom_units=args["bottom_units"],
                     cross_layers=args["cross_layers"], low_rank=args["low_rank"],
                     top_units=args["top_units"], device=device, seed=seed,
                     mesh=mesh)


def port_name(name: str) -> str:
    layer, part = name.split(".")
    for arch in ("bottom", "top"):
        if layer.startswith(arch):
            return f"{arch}.Dense_{layer[len(arch):]}.{part}"
    if layer.startswith("cross"):
        i = layer[5:]
        return {"V": f"cross.V_{i}.weight", "U": f"cross.U_{i}.weight",
                "bias": f"cross.U_{i}.bias"}[part]
    return name


def table_name(dim: int) -> str:
    return f"embedder.table_dim{dim}"
