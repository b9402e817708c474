"""Compile a Features spec into static plans: record schema, batch layout,
and the embedding-table placement plan.

This is the device-first replacement for the reference's per-feature Keras
preprocessing layers (backend/utils/preprocess_utils.py:7-89 +
backend/core/dataloader.py:23-44): instead of building a layer object per
feature, we compile the config once into
  * `RecordSchema`   — how raw values are serialized into record files,
  * `BatchSchema`    — the fixed-shape device batch layout (ids/mask/dense),
  * `TablePlan`      — embedding tables stacked per dim-group with row
                       offsets, ready to shard row-wise across a device mesh.

Everything downstream (pipeline, embedding engine, models) is driven by these
static plans, so the jitted graph has static shapes and zero Python feature
logic inside it.

Batch conventions (all arrays fixed-shape, device-ready):
  * sparse feature f  -> int32 ids [B, H, L]  (H = number of hash salts, 1 for
    lookup/discrete/token_id; L = f.max_len). id 0 is the universal
    pad/masked slot; real ids start at 1.
  * numeric feature f -> float32 [B, L].
  * label tower       -> float32 [B] per label feature.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from recommendflow_tpu_torch.config.features import Feature, Features
from recommendflow_tpu_torch.config.proto import FeatureDeal, FeaturePooling, FeatureTower
from recommendflow_tpu_torch.data.hashing import normalize_seeds

PAD_ID = 0  # universal padding / OOV slot, masked out of pooling


@dataclass(frozen=True)
class FeatureSlot:
    """Static per-feature plan entry."""
    name: str
    kind: str                 # 'sparse' | 'dense' | 'token' | 'embedding'
    deal: FeatureDeal
    tower: FeatureTower
    pooling: FeaturePooling
    dtype: str                # declared config type: int/float/str
    max_len: int
    num_hashes: int = 1       # H: 2 for double-hashed features
    num_rows: int = 0         # embedding table rows (incl. pad slot)
    dim: int = 0              # embedding dim per hash (output = H * dim)
    seeds: Tuple[int, ...] = ()
    vocab: Optional[Tuple[Any, ...]] = None       # lookup vocab values
    boundaries: Optional[Tuple[float, ...]] = None  # discrete bin boundaries

    @property
    def out_dim(self) -> int:
        """Pooled output width of this feature in the tower concat."""
        if self.kind == "dense":
            return self.max_len
        if self.kind == "image":
            return self.dim      # patch-projected embedding width
        if self.kind == "embedding":
            # pre-computed embedding columns concat at their stored width
            # (ops/embedding.py:embed_batch passes them through)
            return self.max_len
        if self.kind == "token":
            # token/segment id sequences feed text encoders, not the tower
            # concat — they contribute no width there
            return 0
        if self.pooling == FeaturePooling.Null:
            # un-pooled sparse features keep the length axis: embed_batch
            # flattens [B, H, L, D] to H*L*D (tower_dim must agree with
            # concat_tower's actual width)
            return self.num_hashes * self.max_len * self.dim
        return self.num_hashes * self.dim

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        if self.kind == "dense":
            return (self.max_len,)
        if self.kind == "sparse":
            return (self.num_hashes, self.max_len)
        if self.kind == "image":
            return (self.max_len, self.max_len, 3)  # max_len = resize side
        return (self.max_len,)   # token ids


@dataclass(frozen=True)
class TableSpec:
    """One logical embedding table (one hash-branch of one feature)."""
    feature: str
    branch: int           # hash branch index (0..H-1)
    num_rows: int         # includes the pad row 0
    dim: int


@dataclass(frozen=True)
class TableGroup:
    """Tables of equal dim stacked row-wise into one [total_rows, dim] array.

    Stacking turns N small gathers into one big gather against a single
    device-resident array — the unit of row-sharding across the mesh and the
    operand of the row-gather kernel (ops/cuda/embedding_bag.py).
    """
    dim: int
    tables: Tuple[TableSpec, ...]
    offsets: Tuple[int, ...]      # row offset of each table in the stack
    total_rows: int

    def offset_of(self, feature: str, branch: int) -> int:
        for t, off in zip(self.tables, self.offsets):
            if t.feature == feature and t.branch == branch:
                return off
        raise KeyError(f"no table for {feature}#{branch} in dim-{self.dim} group")


@dataclass
class BatchSchema:
    """The complete static plan for one config."""
    slots: Dict[str, FeatureSlot]
    order: List[str]                     # deterministic feature order
    label_names: List[str]
    groups: Dict[int, TableGroup]        # dim -> stacked table group
    table_dtype: str = "float32"         # stored table dtype (bf16 halves memory traffic)

    def tower_slots(self, tower: str) -> List[FeatureSlot]:
        # label features never reach slots (compile_schema routes them to
        # label_names), so no kind filter is needed here
        t = FeatureTower(tower)
        return [self.slots[n] for n in self.order if self.slots[n].tower == t]

    def sparse_slots(self) -> List[FeatureSlot]:
        return [self.slots[n] for n in self.order if self.slots[n].kind == "sparse"]

    def dense_slots(self) -> List[FeatureSlot]:
        return [self.slots[n] for n in self.order if self.slots[n].kind == "dense"]

    def tower_dim(self, tower: str) -> int:
        return sum(s.out_dim for s in self.tower_slots(tower))

    def batch_spec(self, batch_size: int) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        """name -> (shape, dtype) for a device batch of `batch_size`."""
        spec: Dict[str, Tuple[Tuple[int, ...], str]] = {}
        for name in self.order:
            s = self.slots[name]
            if s.kind in ("dense", "embedding", "image"):
                spec[name] = ((batch_size,) + s.batch_shape, "float32")
            else:
                spec[name] = ((batch_size,) + s.batch_shape, "int32")
                if s.kind == "bert":
                    spec[f"{name}:seg"] = ((batch_size,) + s.batch_shape, "int32")
        for name in self.label_names:
            spec[name] = ((batch_size,), "float32")
        return spec


def _slot_for(feature: Feature) -> FeatureSlot:
    deal = feature.deal
    if deal in (FeatureDeal.Hashing, FeatureDeal.Lookup,
                FeatureDeal.Discrete) and feature.embedding_dim <= 0:
        # a -1/0 dim would flow into TableSpec -> torch.empty((rows, -1))
        # failing deep in model init with no pointer to the feature
        raise ValueError(
            f"feature '{feature.name}': embedding_dim must be > 0 for "
            f"deal '{deal.value}' (got {feature.embedding_dim})")
    if deal == FeatureDeal.Hashing:
        seeds = tuple(normalize_seeds(feature.hash_seeds, num_hashes=2))
        return FeatureSlot(
            name=feature.name, kind="sparse", deal=deal, tower=feature.tower,
            pooling=feature.pooling, dtype=feature.type, max_len=feature.max_len,
            num_hashes=len(seeds), num_rows=feature.vocab_size + 1,
            dim=feature.embedding_dim, seeds=seeds)
    if deal == FeatureDeal.Lookup:
        vocab = tuple(feature.vocabs) if isinstance(feature.vocabs, list) else None
        if vocab is not None:
            # file-backed vocabs always read as strings (features.py
            # _read_vocab_file) but int-typed record columns decode to
            # int64 — un-coerced, every value would miss the mapping and
            # silently embed as the pad row
            # float32 ROUND-TRIP for float vocabs: record columns decode
            # as float32, so a float64 key like 1.1 would never equal the
            # decoded np.float32(1.1) and every value would miss -> pad
            caster = {"int": int, "str": str,
                      "float": lambda v: float(np.float32(v))}[feature.type]
            try:
                vocab = tuple(caster(v) for v in vocab)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"feature '{feature.name}': vocab entry not castable "
                    f"to declared type '{feature.type}': {e}") from None
        rows = (len(vocab) if vocab else feature.vocab_size) + 1
        return FeatureSlot(
            name=feature.name, kind="sparse", deal=deal, tower=feature.tower,
            pooling=feature.pooling, dtype=feature.type, max_len=feature.max_len,
            num_hashes=1, num_rows=rows, dim=feature.embedding_dim, vocab=vocab)
    if deal == FeatureDeal.Discrete:
        bounds = tuple(float(b) for b in feature.vocabs)
        if list(bounds) != sorted(bounds):
            # np.searchsorted on unsorted boundaries returns meaningless
            # bin ids SILENTLY — fail at compile time, naming the feature
            raise ValueError(
                f"feature '{feature.name}': discrete boundaries must be "
                f"ascending, got {bounds}")
        # bins = len(bounds)+1, shifted +1 to keep slot 0 pad-only (fixes the
        # reference's masked-bin-0 defect, preprocess_layers.py:172-174)
        return FeatureSlot(
            name=feature.name, kind="sparse", deal=deal, tower=feature.tower,
            pooling=feature.pooling, dtype=feature.type, max_len=feature.max_len,
            num_hashes=1, num_rows=len(bounds) + 2, dim=feature.embedding_dim,
            boundaries=bounds)
    if deal == FeatureDeal.TokenId:
        return FeatureSlot(
            name=feature.name, kind="token", deal=deal, tower=feature.tower,
            pooling=feature.pooling, dtype=feature.type,
            max_len=max(feature.max_len, 1))
    if deal == FeatureDeal.BertEncode:
        # raw text column tokenized host-side at batch time (the BertEncode
        # layer's role, preprocess_layers.py:109-132); emits token ids under
        # the feature name plus '<name>:seg' segment ids. vocabs holds the
        # vocab file path (features.py resolution).
        return FeatureSlot(
            name=feature.name, kind="bert", deal=deal, tower=feature.tower,
            pooling=feature.pooling, dtype=feature.type,
            max_len=max(feature.max_len, 8),
            vocab=(feature.vocabs,) if isinstance(feature.vocabs, str) else None)
    if deal in (FeatureDeal.Numeric, FeatureDeal.Null):
        return FeatureSlot(
            name=feature.name, kind="dense", deal=deal, tower=feature.tower,
            pooling=feature.pooling, dtype=feature.type, max_len=feature.max_len)
    if deal == FeatureDeal.Embedding:
        return FeatureSlot(
            name=feature.name, kind="embedding", deal=deal, tower=feature.tower,
            pooling=feature.pooling, dtype=feature.type, max_len=feature.max_len)
    if deal == FeatureDeal.Image:
        # raw encoded image column decoded host-side (PIL) to a fixed
        # [side, side, 3] float tensor, patch-projected on device to
        # embedding_dim (reference: decode_jpeg/webp second parse,
        # dataloader.py:60-89). max_len doubles as the resize side
        # (max_len_map entry); default 64, rounded to a multiple of the
        # 8x8 patch so the patchify reshape is exact.
        side = feature.max_len if feature.max_len > 1 else 64
        side = max(8, -(-side // 8) * 8)
        return FeatureSlot(
            name=feature.name, kind="image", deal=deal, tower=feature.tower,
            pooling=feature.pooling, dtype=feature.type, max_len=side,
            dim=feature.embedding_dim if feature.embedding_dim > 0 else 64)
    raise NotImplementedError(f"deal '{deal.value}' not yet supported on the device path "
                              f"(feature '{feature.name}')")


def compile_schema(features: Features) -> BatchSchema:
    """Compile working features into the static batch/table plan."""
    slots: Dict[str, FeatureSlot] = {}
    order: List[str] = []
    label_names: List[str] = []
    for f in features.train_features:
        if f.tower == FeatureTower.Label or (
                f.deal == FeatureDeal.Numeric and f.tower == FeatureTower.Null):
            if f.tower != FeatureTower.Label:
                # legacy convention: a working numeric feature with NO
                # tower is treated as a label column — loudly, because a
                # user who merely forgot the tower would otherwise lose
                # the feature from every tower with no signal
                from recommendflow_tpu_torch.utils.logger import get_logger
                get_logger("recflow.schema").warning(
                    "feature '%s' (numeric, tower=null) is treated as a "
                    "LABEL column; set a tower if it was meant as an "
                    "input feature", f.name)
            label_names.append(f.name)
            continue
        slot = _slot_for(f)
        slots[f.name] = slot
        order.append(f.name)

    by_dim: Dict[int, List[TableSpec]] = {}
    for name in order:
        s = slots[name]
        if s.kind != "sparse":
            continue
        for h in range(s.num_hashes):
            by_dim.setdefault(s.dim, []).append(
                TableSpec(feature=name, branch=h, num_rows=s.num_rows, dim=s.dim))

    groups: Dict[int, TableGroup] = {}
    for dim, tables in sorted(by_dim.items()):
        offsets, acc = [], 0
        for t in tables:
            offsets.append(acc)
            acc += t.num_rows
        groups[dim] = TableGroup(dim=dim, tables=tuple(tables),
                                 offsets=tuple(offsets), total_rows=acc)
    return BatchSchema(slots=slots, order=order, label_names=label_names, groups=groups)


def check_batch_ids(schema: BatchSchema, batch: Mapping[str, Any]
                    ) -> Mapping[str, Any]:
    """Raise IndexError, naming the feature and the id, if a sparse slot's
    ids leave [0, num_rows) of its own table; return the batch unchanged.

    Runs on the host while the batch is still numpy (or CPU tensors), in the
    trainer's prefetch thread, so that the embedding gather on the card never
    reads ids back to check them. Where the JAX package's take fills a row
    with NaN (an id past the stacked table) or wraps (a negative id), or
    reads the next table's row (an id past its own table), the port
    raises. One maximum a slot over the slots' ids viewed as unsigned (a
    negative id reads as a huge one), in one numpy call: the check shares
    the interpreter with the thread that drives the card."""
    return check_ids_in_range(
        {slot.name: slot.num_rows for slot in schema.sparse_slots()}, batch)


def check_ids_in_range(num_rows: Mapping[str, int], batch: Mapping[str, Any]
                       ) -> Mapping[str, Any]:
    """`check_batch_ids` on a map of sparse feature name -> its table's row
    count (what an exported model keeps of its schema)."""
    ids = [(name, rows, np.asarray(batch[name]).reshape(-1))
           for name, rows in num_rows.items() if name in batch]
    ids = [(name, rows, a) for name, rows, a in ids if a.size]
    if not ids:
        return batch
    flat = np.concatenate([a for _, _, a in ids])
    if not np.issubdtype(flat.dtype, np.integer):
        raise TypeError(f"sparse ids must be integers, got {flat.dtype}")
    unsigned = flat.view(np.dtype(f"u{flat.itemsize}"))
    starts = np.cumsum([0] + [a.size for _, _, a in ids[:-1]])
    rows = np.array([r for _, r, _ in ids], dtype=unsigned.dtype)
    over = np.flatnonzero(np.maximum.reduceat(unsigned, starts) >= rows)
    if over.size:
        name, n_rows, a = ids[over[0]]
        bad = int(a[(a < 0) | (a >= n_rows)][0])
        raise IndexError(f"feature '{name}': id {bad} outside its "
                         f"table's {n_rows} rows")
    return batch


@lru_cache(maxsize=16)
def get_tokenizer(vocab_path: str):
    """Shared tokenizer per vocab file (bert_encode deal host tokenization)."""
    from recommendflow_tpu_torch.encoder.tokenizer import Tokenizer
    return Tokenizer(vocab_path)


# ----------------------------------------------------------- host encoders
@lru_cache(maxsize=256)
def _lookup_map(vocab: Tuple[Any, ...]) -> Dict[Any, int]:
    """value -> 1-based id, built once per vocab (hot decode path: rebuilding
    a 100k-entry dict per block would dominate host time)."""
    return {v: i + 1 for i, v in enumerate(vocab)}


def encode_lookup(values: np.ndarray, vocab: Sequence[Any]) -> np.ndarray:
    """Map raw values -> table ids (1-based; unknown/missing -> PAD_ID)."""
    mapping = _lookup_map(tuple(vocab))
    flat = np.asarray(
        [mapping.get(v, PAD_ID) for v in np.asarray(values, dtype=object).ravel()],
        dtype=np.int64)
    return flat.reshape(np.shape(values))


def encode_discrete(values: np.ndarray, boundaries: Sequence[float]) -> np.ndarray:
    """Bucketize floats -> bin ids shifted +1 (PAD_ID reserved for missing)."""
    b = np.asarray(boundaries, dtype=np.float64)
    v = np.asarray(values, dtype=np.float64)
    return (np.searchsorted(b, v, side="right") + 1).astype(np.int64)
