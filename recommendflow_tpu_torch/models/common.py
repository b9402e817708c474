"""Shared model helpers: input assembly for ranking/CTR models (the
counterpart of `recommendflow_tpu/models/common.py`).

Ranking models consume every working non-label feature regardless of tower.
Helpers here produce (a) the flat concat vector and (b) the [B, F, D] field
embedding tensor (same-dim features only) that FM/CIN need, and the widths
of both, which a torch module needs when it is built.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

from recommendflow_tpu_torch.data.schema import BatchSchema, FeatureSlot


def input_slots(schema: BatchSchema) -> List[FeatureSlot]:
    """Every slot that contributes a pooled vector to the model input,
    including precomputed 'embedding' columns and 'image' features. Token
    and bert sequences feed text encoders, not the flat concat."""
    return [schema.slots[n] for n in schema.order
            if schema.slots[n].kind in ("sparse", "dense", "embedding",
                                        "image")]


def input_dim(schema: BatchSchema) -> int:
    """Width of `concat_all`'s output."""
    return sum(s.out_dim for s in input_slots(schema))


def concat_all(features: Dict[str, torch.Tensor],
               schema: BatchSchema) -> torch.Tensor:
    """All pooled features in schema order -> [B, D_total]."""
    parts = [features[s.name] for s in input_slots(schema) if s.name in features]
    if not parts:
        raise ValueError("no input features produced — check working flags")
    return torch.cat(parts, dim=-1)


def _field_slots(schema: BatchSchema, dim: Optional[int]
                 ) -> Tuple[int, List[FeatureSlot]]:
    sparse = [s for s in input_slots(schema) if s.kind == "sparse"]
    if not sparse:
        raise ValueError("no sparse features for field interactions")
    if dim is None:
        dim = Counter(s.dim for s in sparse).most_common(1)[0][0]
    return dim, [s for s in sparse if s.dim == dim]


def field_shape(schema: BatchSchema, dim: Optional[int] = None
                ) -> Tuple[int, int]:
    """(F, D) of `field_stack`'s [B, F, D] output."""
    dim, slots = _field_slots(schema, dim)
    return sum(s.num_hashes for s in slots), dim


def field_stack(features: Dict[str, torch.Tensor], schema: BatchSchema,
                dim: Optional[int] = None) -> Tuple[torch.Tensor, List[str]]:
    """Same-width pooled embeddings stacked to [B, F, D] for interaction
    layers. Picks the majority output width unless `dim` is given; hashing
    features contribute their two branches as two fields each."""
    dim, slots = _field_slots(schema, dim)
    fields, names = [], []
    for s in slots:
        if s.name not in features:
            continue
        emb = features[s.name]                        # [B, H*dim]
        fields.append(emb.reshape(emb.shape[0], s.num_hashes, dim))
        for h in range(s.num_hashes):
            names.append(f"{s.name}#{h}" if s.num_hashes > 1 else s.name)
    return torch.cat(fields, dim=1), names


def get_labels(batch: Dict[str, torch.Tensor], schema: BatchSchema,
               n: int = 1, training: bool = False) -> List[torch.Tensor]:
    """First n label columns. Missing columns zero-fill for serving batches;
    during training they are a misconfiguration that would silently train a
    task against all-zero targets, so they raise (training=True)."""
    out = []
    some = next(iter(batch.values()))
    for i in range(n):
        if i < len(schema.label_names) and schema.label_names[i] in batch:
            out.append(batch[schema.label_names[i]])
        elif training:
            want = schema.label_names[i] if i < len(schema.label_names) \
                else f"<label #{i}>"
            raise ValueError(
                f"model needs {n} label columns but '{want}' is missing "
                f"from the batch (labels configured: {schema.label_names})")
        else:
            out.append(torch.zeros(some.shape[0], dtype=torch.float32,
                                   device=some.device))
    return out


def bce_probs(y_true: torch.Tensor, p: torch.Tensor,
              eps: float = 1e-7) -> torch.Tensor:
    """Element-wise BCE on probabilities (clipped), shared by the multi-task
    rankers."""
    p = torch.clamp(p, eps, 1 - eps)
    return -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p))


def bce_with_logits(y_true: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp(logits, min=0) - logits * y_true +
                      torch.log1p(torch.exp(-torch.abs(logits))))


def token_slots(schema: BatchSchema, tower: str) -> List[FeatureSlot]:
    """A tower's token and bert features (text encoder inputs), in config
    order."""
    return [s for s in schema.tower_slots(tower) if s.kind in ("token", "bert")]


def text_encoder_kwargs(model, pretrained_name: str, pooling: str,
                        vocab_size: int, num_layers: int, model_dim: int
                        ) -> Dict[str, object]:
    """TextEncoder constructor kwargs for a model's encoder: sized from the
    `bert_config.json` of `Networks.pretrained.<pretrained_name>` when the
    config names one (so the trainer's graft matches its shapes), else the
    given widths; max_len is the spec's, else the model's token_max_len()."""
    pre = (model.network_conf("pretrained") or {}).get(pretrained_name)
    if pre:
        from recommendflow_tpu_torch.encoder.pretrained import bert_encoder_kwargs
        return bert_encoder_kwargs(
            pre["config_path"], max_len=pre.get("max_len") or model.token_max_len(),
            pooling=pooling)
    return dict(vocab_size=vocab_size, num_layers=num_layers,
                model_dim=model_dim, pooling=pooling,
                max_len=model.token_max_len())
