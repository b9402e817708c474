"""Model base: the contract every zoo model follows (the counterpart of
`recommendflow_tpu/models/base.py`).

Models are `nn.Module`s built from a Configuration. In eval mode
`forward(batch)` returns a dict of outputs (embeddings / scores / labels);
the training forward arrives with the trainer.

Models load reflectively by dotted path through `build_network`, named in
YAML `Networks.class`. Configs name the JAX package's classes
(`recommendflow_tpu.models.matching.dssm.Dssm`); the prefix is mapped onto
this package by string, so the JAX package is never imported.
"""
from __future__ import annotations

import importlib
import math
import pkgutil
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.data.schema import BatchSchema, compile_schema
from recommendflow_tpu_torch.ops.embedding import (concat_tower, embed_batch,
                                                   init_group_table)

Batch = Dict[str, torch.Tensor]

PKG = "recommendflow_tpu_torch"
REFERENCE_PKG = "recommendflow_tpu"
STAGES = ("matching", "preranking", "ranking", "reranking")


class FeatureEmbedder(nn.Module):
    """Owns the stacked embedding tables (`table_dim{d}`, stored layout) and
    maps a batch to pooled per-feature embeddings."""

    def __init__(self, schema: BatchSchema, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.schema = schema
        dtype = getattr(schema, "table_dtype", "float32")
        for name in schema.order:
            if schema.slots[name].kind == "image":
                raise NotImplementedError(
                    f"image feature '{name}' needs the image encoder, which "
                    f"recommendflow_tpu_torch does not have yet")
        for dim, group in schema.groups.items():
            table = init_group_table(generator, group, dtype, device=device)
            self.register_parameter(f"table_dim{dim}", nn.Parameter(table))

    def tables(self) -> Dict[str, torch.Tensor]:
        return {f"dim{dim}": getattr(self, f"table_dim{dim}")
                for dim in self.schema.groups}

    def forward(self, batch: Batch, tower: Optional[str] = None,
                exclude=()) -> Dict[str, torch.Tensor]:
        return embed_batch(self.tables(), self.schema, batch, tower=tower,
                           exclude=exclude)

    def tower_vector(self, batch: Batch, tower: str) -> torch.Tensor:
        return concat_tower(self(batch, tower), self.schema, tower)

    def tower_vectors(self, batch: Batch, towers: Sequence[str]
                      ) -> List[torch.Tensor]:
        """All towers' vectors from ONE pass: one gather per dim group for
        every tower together."""
        feats = self(batch)
        return [concat_tower(feats, self.schema, t) for t in towers]


def init_dense_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's Dense defaults on every Linear below `module`: kernel
    lecun_normal (normal truncated at two standard deviations, rescaled to
    variance 1/fan_in), bias zero. BatchNorm keeps scale 1, bias 0, mean 0,
    var 1."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / .87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                m.bias.zero_()


class RecModel(nn.Module):
    """Base class: wires Configuration -> schema. `loss` (a callable or a
    dotted name, default Networks.loss) is kept for the training forward."""

    def __init__(self, conf: Configuration, loss: Any = None):
        super().__init__()
        self.conf = conf
        self.loss = loss
        schema = compile_schema(conf.features)
        schema.table_dtype = str(conf.networks.get("table_dtype", "float32"))
        schema.image_encoder = str(conf.networks.get("image_encoder", "linear"))
        self.schema = schema
        if self.network_conf("logq_feature"):
            raise NotImplementedError(
                "Networks.logq_feature (sampled-softmax logQ correction) "
                "arrives with the training slice")

    def network_conf(self, key: str, default=None):
        return self.conf.networks.get(key, default)


def _candidates(class_path: str) -> List[str]:
    path = class_path.strip()
    if path.startswith(REFERENCE_PKG + ".") and not path.startswith(PKG + "."):
        path = PKG + path[len(REFERENCE_PKG):]
    candidates = [path]
    if not path.startswith(PKG + "."):
        candidates.append(f"{PKG}.models.{path}")
        if "." not in path:
            camel = "".join(p.capitalize() for p in path.lower().split("_"))
            for stage in STAGES:
                candidates.append(f"{PKG}.models.{stage}.{path.lower()}.{camel}")
    if path.startswith("models."):
        candidates.append(f"{PKG}.{path}")
    return candidates


def _resolve_class(class_path: str):
    candidates = _candidates(class_path)
    last_err: Optional[Exception] = None
    for cand in candidates:
        module_name, _, cls_name = cand.rpartition(".")
        if not module_name:
            continue
        try:
            module = importlib.import_module(module_name)
        except ModuleNotFoundError as e:
            if e.name and (module_name == e.name
                           or module_name.startswith(e.name + ".")):
                last_err = e       # the candidate itself doesn't exist
                continue
            raise                  # the module exists but its imports broke
        cls = getattr(module, cls_name, None)
        if not isinstance(cls, type):
            # the module is right, the class casing isn't ('xdeepfm')
            matches = [v for k, v in vars(module).items()
                       if k.lower() == cls_name.lower() and isinstance(v, type)]
            if not matches:
                last_err = AttributeError(f"{module_name} has no {cls_name}")
                continue
            cls = matches[0]
        return cls
    if "." not in class_path.strip():
        cls = _scan_zoo(class_path.strip())
        if cls is not None:
            return cls
    raise ImportError(f"cannot resolve model class '{class_path}' "
                      f"(tried {candidates}): {last_err}")


def build_network(class_path: str, model_kwargs: Dict[str, Any],
                  checkpoint_path: Optional[str] = None) -> Tuple[nn.Module, Any]:
    """'recommendflow_tpu.models.matching.dssm.Dssm' (or a short name:
    'dssm', 'matching.dssm.Dssm') -> (model instance, restored variable tree
    or None). The checkpoint is an .npz of a flattened flax variable tree
    (interop.py); the caller loads it with interop.load_jax_variables."""
    model = _resolve_class(class_path)(**model_kwargs)
    restored = None
    if checkpoint_path:
        from recommendflow_tpu_torch.interop import load_variables_npz
        restored = load_variables_npz(checkpoint_path)
    return model, restored


def _scan_zoo(name: str):
    """Find a zoo class by case/underscore-insensitive bare name."""
    want = name.lower().replace("_", "")
    for stage in STAGES:
        try:
            pkg = importlib.import_module(f"{PKG}.models.{stage}")
        except ModuleNotFoundError:
            continue
        for info in pkgutil.iter_modules(pkg.__path__):
            mod = importlib.import_module(f"{PKG}.models.{stage}.{info.name}")
            for k, v in vars(mod).items():
                if (isinstance(v, type) and v.__module__ == mod.__name__
                        and k.lower().replace("_", "") == want):
                    return v
    return None
