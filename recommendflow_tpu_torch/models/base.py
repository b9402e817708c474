"""Model base: the contract every zoo model follows (the counterpart of
`recommendflow_tpu/models/base.py`).

Models are `nn.Module`s built from a Configuration. In training mode
(`model.train()`) `forward(batch)` returns `(loss, aux)`, a scalar loss and a
dict of metric tensors; in eval mode a dict of outputs (embeddings / scores /
labels).

Models load reflectively by dotted path through `build_network`, named in
YAML `Networks.class`. Configs name the JAX package's classes
(`recommendflow_tpu.models.matching.dssm.Dssm`); the prefix is mapped onto
this package by string, so the JAX package is never imported.
"""
from __future__ import annotations

import importlib
import math
import pkgutil
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.data.schema import BatchSchema, compile_schema
from recommendflow_tpu_torch.losses.match import global_batch_loss
from recommendflow_tpu_torch.ops.embedding import (IMAGE_PATCH, _global_ids,
                                                   concat_tower, embed_batch,
                                                   gather_group,
                                                   init_group_block,
                                                   init_group_table,
                                                   table_shape)
from recommendflow_tpu_torch.ops.mlp import ExpertsDense
from recommendflow_tpu_torch.parallel.distributed import all_gather_nograd
from recommendflow_tpu_torch.parallel.mesh import (Mesh, active_data_parallel,
                                                   table_sharding_rules)
from recommendflow_tpu_torch.train.freq import freq_init, freq_update, log_q
from recommendflow_tpu_torch.utils.str_parser import str2fn

Batch = Dict[str, torch.Tensor]

PKG = "recommendflow_tpu_torch"
REFERENCE_PKG = "recommendflow_tpu"
STAGES = ("matching", "preranking", "ranking", "reranking")


class FeatureEmbedder(nn.Module):
    """Owns the stacked embedding tables (`table_dim{d}`, stored layout) and
    maps a batch to pooled per-feature embeddings.

    An image slot gets a patch projection `img_proj_{name}` [192, dim] f32
    (lecun_normal), or under `Networks.image_encoder: vit` an
    `ImageEncoder` named `vit_{name}` (the class defaults, out_dim the
    slot's dim). The JAX embedder calls its ViT without `training`, so the
    ViT's dropout never drops: here it stays in eval mode whatever mode the
    model is put in.

    With a `mesh`, each stacked table that the mesh's rules row-shard over
    'dp' (`parallel.mesh.table_sharding_rules`) is made as this rank's
    block alone (`init_group_block`; its `whole_rows` the whole table's
    stored rows): a table larger than one card is never made whole.
    `Trainer(mesh=mesh, shard_tables=True)` marks it (`mark_row_shard`); a
    Trainer that does not row-shard it refuses the model."""

    def __init__(self, schema: BatchSchema, generator: torch.Generator,
                 device=None, mesh: Optional[Mesh] = None):
        super().__init__()
        self.schema = schema
        dtype = getattr(schema, "table_dtype", "float32")
        for dim, group in schema.groups.items():
            name = f"table_dim{dim}"
            whole = table_shape(group, dtype)
            if mesh is not None and table_sharding_rules(
                    {name: torch.empty(whole, device="meta")}, mesh)[name]:
                param = nn.Parameter(init_group_block(
                    generator, group, mesh.rank("dp"), mesh.size("dp"), dtype,
                    device=device))
                param.whole_rows = whole[0]
            else:
                param = nn.Parameter(init_group_table(generator, group, dtype,
                                                      device=device))
            self.register_parameter(name, param)
        vit = getattr(schema, "image_encoder", "linear") == "vit"
        self._images: List[str] = []
        for name in schema.order:
            slot = schema.slots[name]
            if slot.kind != "image":
                continue
            self._images.append(name)
            if vit:
                from recommendflow_tpu_torch.ops.transformer import ImageEncoder
                self.add_module(f"vit_{name}", ImageEncoder(
                    slot.max_len, out_dim=slot.dim, generator=generator,
                    device=device))
            else:
                fan_in = IMAGE_PATCH * IMAGE_PATCH * 3
                proj = torch.empty((fan_in, slot.dim), device=device)
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(proj, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                self.register_parameter(f"img_proj_{name}", nn.Parameter(proj))

    def train(self, mode: bool = True) -> "FeatureEmbedder":
        super().train(mode)
        for name in self._images:
            if hasattr(self, f"vit_{name}"):
                getattr(self, f"vit_{name}").train(False)
        return self

    def tables(self) -> Dict[str, torch.Tensor]:
        """'dim{d}' -> stacked table, 'img_{name}' -> patch projection."""
        out = {f"dim{dim}": getattr(self, f"table_dim{dim}")
               for dim in self.schema.groups}
        for name in self._images:
            if hasattr(self, f"img_proj_{name}"):
                out[f"img_{name}"] = getattr(self, f"img_proj_{name}")
        return out

    def forward(self, batch: Batch, tower: Optional[str] = None,
                exclude=()) -> Dict[str, torch.Tensor]:
        out = embed_batch(self.tables(), self.schema, batch, tower=tower,
                          exclude=exclude)
        for name in self._images:
            vit = getattr(self, f"vit_{name}", None)
            if vit is not None and (tower is None or self.schema.slots[name]
                                    in self.schema.tower_slots(tower)):
                out[name] = vit(batch[name].float())
        return out

    def unpooled(self, batch: Batch, name: str) -> torch.Tensor:
        """One sparse feature's raw per-position embeddings [B, H, L, D],
        for models that pool a sequence themselves: pair it with
        `forward(..., exclude=[name])` so its rows are gathered once."""
        slot = self.schema.slots[name]
        return gather_group(getattr(self, f"table_dim{slot.dim}"),
                            self.schema.groups[slot.dim],
                            _global_ids(self.schema, slot, batch[name]))

    def tower_vector(self, batch: Batch, tower: str) -> torch.Tensor:
        return concat_tower(self(batch, tower), self.schema, tower)

    def tower_vectors(self, batch: Batch, towers: Sequence[str]
                      ) -> List[torch.Tensor]:
        """All towers' vectors from ONE pass: one gather per dim group for
        every tower together."""
        feats = self(batch)
        return [concat_tower(feats, self.schema, t) for t in towers]


def init_dense_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's Dense defaults on every Linear (and batched ExpertsDense)
    below `module`: kernel lecun_normal (normal truncated at two standard
    deviations, rescaled to variance 1/fan_in), bias zero where the layer
    has one. BatchNorm keeps scale 1, bias 0, mean 0, var 1."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, ExpertsDense)):
            std = math.sqrt(1.0 / m.in_features) / .87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


class FreqEstimator(nn.Module):
    """The logQ correction's streaming frequency state (train/freq.py) as
    buffers, so state_dict, checkpoints and the trainer's buffer restore
    carry it: last_step [buckets] int32, interval [buckets] f32 and the
    stream's step [] int32 (the JAX package's 'freq' collection:
    freq/state/{last_step, interval} and freq/step)."""

    def __init__(self, buckets: int, device=None):
        super().__init__()
        state = freq_init(buckets, device)
        self.register_buffer("last_step", state["last_step"])
        self.register_buffer("interval", state["interval"])
        self.register_buffer("step", torch.zeros((), dtype=torch.int32,
                                                 device=device))

    def state(self) -> Dict[str, torch.Tensor]:
        return {"last_step": self.last_step, "interval": self.interval}


class RecModel(nn.Module):
    """Base class: wires Configuration -> schema and resolves the loss (a
    callable or a dotted name, default Networks.loss)."""

    # True on models whose forward reads embedding tables through exactly
    # ONE full-batch embed_batch pass: the trainer's split table-update path
    # then gathers the rows outside autograd and hands them in
    # (ops/embedding.py:rows_key). A model with any other table read must
    # keep this False, or that read's gradient is dropped (the trainer
    # checks: train/trainer.py:Trainer._validate_row_injection).
    row_injection = False

    def __init__(self, conf: Configuration, loss: Any = None):
        super().__init__()
        self.conf = conf
        self.loss = loss
        schema = compile_schema(conf.features)
        schema.table_dtype = str(conf.networks.get("table_dtype", "float32"))
        schema.image_encoder = str(conf.networks.get("image_encoder", "linear"))
        self.schema = schema

    def resolve_loss(self) -> Callable:
        """The loss callable (resolved once: the training forward calls this
        every step). Inside a `parallel.mesh.data_parallel` block, where
        each rank holds its own rows of the batch, the loss as the global
        batch sees it (`losses.match.global_batch_loss`)."""
        if getattr(self, "_loss_fn", None) is None:
            loss = self.loss if self.loss is not None \
                else self.conf.networks.get("loss")
            if loss is None:
                raise ValueError("no loss given (model arg or Networks.loss)")
            self._loss_fn = str2fn(loss) if isinstance(loss, str) else loss
        dp = active_data_parallel()
        if dp is not None:
            return global_batch_loss(self._loss_fn, dp[1])
        return self._loss_fn

    def init_logq(self, device=None) -> None:
        """Under `Networks.logq_feature` (a sparse item feature), the
        frequency state `freq` of `logq_correction`, with
        `Networks.logq_buckets` buckets (default 1 << 20). A model that
        calls logq_correction builds it in its constructor."""
        if self.network_conf("logq_feature"):
            buckets = int(self.network_conf("logq_buckets") or (1 << 20))
            self.freq = FreqEstimator(buckets, device)

    def logq_correction(self, batch: Batch) -> Optional[torch.Tensor]:
        """The sampled-softmax bias correction's input (Yi et al. 2019): the
        batch docs' log q [B] for the loss's `logq=`, from the streaming
        frequency estimate over the first id of `Networks.logq_feature` per
        example (modulo the bucket count), or None when unconfigured. The
        estimate is read before this batch; a training forward then
        advances the stream by one step (`Networks.logq_alpha`, default
        0.05). Evaluation leaves it as it is."""
        feat = self.network_conf("logq_feature")
        if not feat:
            return None
        ids = batch[feat].reshape(batch[feat].shape[0], -1)[:, 0] \
            % self.freq.last_step.shape[0]
        lq = log_q(self.freq.state(), ids)
        if self.training:
            alpha = float(self.network_conf("logq_alpha") or 0.05)
            dp = active_data_parallel()
            if dp is not None:
                # the stream advances by the global batch's ids, in order,
                # on every rank
                ids = all_gather_nograd(ids, dp[0].group(dp[1]))
            with torch.no_grad():
                self.freq.step.add_(1)
                freq_update(self.freq.state(), ids, self.freq.step,
                            alpha=alpha)
        return lq

    def token_max_len(self, default: int = 64) -> int:
        """Longest token feature in the schema: sizes a TextEncoder's max_len
        so its length guard matches what the pipeline emits."""
        lens = [s.max_len for s in self.schema.slots.values()
                if s.kind in ("token", "bert")]
        return max(lens) if lens else default

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
