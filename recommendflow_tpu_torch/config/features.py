"""Feature grammar: per-feature specs compiled from YAML config rows.

Capability parity with the reference's config_parser/features.py:17-415 —
feature groups (incl. integer-slot `[a, b, ..., z]` ellipsis expansion and
slot-map files), vocab resolution (literal list / `$vocab` variable / int
bucket size / __AUTO__), working-flag toggles, tower/deal/pooling query API and
dynamic `{deal}_features` attributes — re-designed as plain dataclasses with no
framework types so the result can be compiled into static device plans
(data/schema.py) downstream.
"""
from __future__ import annotations

import re as _re

import csv
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

from recommendflow_tpu_torch.config.proto import (
    DEFAULT_MAP, EMBEDDING_DEALS, NO_DIM_DEALS, SUPPORT_TYPE,
    FeatureDeal, FeaturePooling, FeatureTower,
)
from recommendflow_tpu_torch.utils.str_parser import str2list

AUTO_VOCAB = "__AUTO__"


def _int_cell(group: str, field: str, raw) -> int:
    """int() with a clear error: '$' variables are NOT resolved in numeric
    feature-row cells (only the vocab column supports $names) — the bare
    int() crash pointed at nothing."""
    s = str(raw)
    if s.startswith("$"):
        raise ValueError(
            f"feature '{group}': '$' variables are not supported in the "
            f"{field} cell — inline the literal value ($names resolve only "
            "in the vocab column)")
    return int(s)


@dataclass
class Feature:
    """One feature's spec. Equality/hash by name so a Feature can key dicts
    alongside plain strings (reference features.py:71-89 contract)."""
    name: str
    field_name: str
    type: str                      # 'int' | 'float' | 'str'
    tower: FeatureTower
    deal: FeatureDeal
    vocab_size: int = -1
    embedding_dim: int = -1
    pooling: FeaturePooling = FeaturePooling.Null
    working: bool = True
    vocabs: Optional[Union[List[Any], str]] = None
    hash_seeds: Optional[Sequence[int]] = None
    max_len: int = 1               # padded sequence length in device batches

    def __post_init__(self):
        if self.type not in SUPPORT_TYPE:
            raise ValueError(
                f"feature '{self.name}': type must be one of {SUPPORT_TYPE}, got '{self.type}'")
        self.default = DEFAULT_MAP[self.type]
        if isinstance(self.vocabs, list):
            if self.deal == FeatureDeal.Discrete:
                # discrete vocabs are bin BOUNDARIES (thresholds), not
                # values — int-casting [0.5, 1.5] for an int-typed feature
                # would silently shift every bucket assignment
                self.vocabs = [float(v) for v in self.vocabs]
            else:
                caster = {"int": int, "float": float, "str": str}[self.type]
                self.vocabs = [caster(v) for v in self.vocabs]

    # --- predicates -------------------------------------------------------
    def is_hashing(self) -> bool:
        return self.deal == FeatureDeal.Hashing

    def is_lookup(self) -> bool:
        return self.deal == FeatureDeal.Lookup

    def is_discrete(self) -> bool:
        return self.deal == FeatureDeal.Discrete

    def is_numeric(self) -> bool:
        return self.deal == FeatureDeal.Numeric

    def is_token_id(self) -> bool:
        return self.deal == FeatureDeal.TokenId

    def is_image(self) -> bool:
        return self.deal == FeatureDeal.Image

    def is_embedding(self) -> bool:
        return self.deal == FeatureDeal.Embedding

    def is_bert_encode(self) -> bool:
        return self.deal == FeatureDeal.BertEncode

    def is_auto_vocabs(self) -> bool:
        return isinstance(self.vocabs, str) and self.vocabs.upper() == AUTO_VOCAB

    def has_table(self) -> bool:
        return self.deal in EMBEDDING_DEALS and self.working

    # --- identity by name -------------------------------------------------
    def __hash__(self):
        return hash(self.name)

    def __eq__(self, other):
        return self.name == getattr(other, "name", other)

    def __lt__(self, other):
        return self.name < getattr(other, "name", other)

    def __gt__(self, other):
        return self.name > getattr(other, "name", other)

    def __repr__(self):
        return (f"Feature({self.name}, field={self.field_name}, type={self.type}, "
                f"tower={self.tower.value}, deal={self.deal.value}, vocab={self.vocab_size}, "
                f"dim={self.embedding_dim}, pool={self.pooling.value}, working={self.working})")


def load_slot_map(path: str) -> Dict[int, List[str]]:
    """Parse a `name:Type:slot` slot-map file (reference conf/*.feature.map
    format, config_parser/config_utils.py:21-33) into {slot: [name, type]}."""
    type_names = {"stringtype": "str", "integertype": "int", "longtype": "int",
                  "floattype": "float", "doubletype": "float"}
    out: Dict[int, List[str]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, tname, slot = line.split(":")
            out[int(slot)] = [name, type_names.get(tname.lower(), "str")]
    return out


def _read_vocab_file(path: str) -> List[str]:
    """Read a vocab file: TSV/CSV with the id in the first column, or one
    token per line. Matches reference semantics (vocab CSV first column
    uniques, features.py:199-201)."""
    values: List[str] = []
    seen = set()
    with open(path, newline="") as f:
        sample = f.read(4096)
        f.seek(0)
        delim = "\t" if "\t" in sample else ("," if "," in sample else None)
        if delim:
            for row in csv.reader(f, delimiter=delim):
                if not row:
                    continue
                v = row[0].strip()
                if v and v not in seen:
                    seen.add(v)
                    values.append(v)
        else:
            for line in f:
                v = line.strip()
                if v and v not in seen:
                    seen.add(v)
                    values.append(v)
    return values


def _expand_ellipsis(names: List[Any]) -> List[Any]:
    """Expand `[1, 4, ..., 71]` style integer ranges: `...` consumes its two
    int neighbours and inserts range(start, end+1) (reference features.py:218-224)."""
    names = list(names)
    while "..." in names:
        i = names.index("...")
        if i == 0 or i == len(names) - 1:
            raise ValueError(f"'...' must sit between two ints: {names}")
        start, end = names[i - 1], names[i + 1]
        if not (isinstance(start, int) and isinstance(end, int)):
            raise ValueError(f"'...' neighbours must be ints, got {start!r}, {end!r}")
        if start >= end:
            raise ValueError(f"'...' range start={start} must be < end={end}")
        names = names[: max(0, i - 1)] + list(range(start, end + 1)) + names[i + 2:]
    return names


class Features:
    """The parsed feature table plus its query algebra.

    Parameters
    ----------
    conf : the full config dict (needs conf['Features'])
    vocabs_map : the Variables.vocabs dict ($name -> list | path)
    seeds : hashing seeds (int or [int, int])
    slot_map_path : optional `name:Type:slot` map for integer-slot groups
    """

    def __init__(self,
                 conf: Dict[str, Any],
                 vocabs_map: Optional[Dict[str, Any]] = None,
                 seeds: Union[int, Sequence[int], None] = None,
                 slot_map_path: Optional[str] = None,
                 default_max_len: int = 1,
                 max_len_map: Optional[Dict[str, int]] = None,
                 vocab_reader=None):
        self.conf = conf
        self.vocabs_map = dict(vocabs_map or {})
        # injectable vocab-file reader: lets configs whose vocab paths point
        # at unreachable stores (hdfs://) be parsed offline — tests and dry
        # runs inject a stub; None = read the real file
        self.vocab_reader = vocab_reader or _read_vocab_file
        self.seeds = seeds
        self.slot_map = load_slot_map(slot_map_path) if slot_map_path else {}
        self.default_max_len = default_max_len
        # group names lowercase at parse time; mixed-case map keys would
        # silently miss and truncate sequences to default_max_len
        self.max_len_map = {str(k).lower(): v
                            for k, v in (max_len_map or {}).items()}

        fsec = conf["Features"]
        fields = fsec["feature_fields"]
        self.field_names: List[str] = fields if isinstance(fields, list) else str2list(fields)
        self.feature_group = self._init_groups(fsec.get("feature_group") or {})
        self.features: List[Feature] = self._init_features(fsec["features"])
        self._set_deal_attrs()

    # ------------------------------------------------------------------ init
    @staticmethod
    def _init_groups(raw: Dict[str, Any]) -> Dict[str, List[Any]]:
        def coerce(n):
            # packed-string groups yield DIGIT STRINGS; the slot-map /
            # ellipsis logic keys on real ints — '0,2,...,9' must behave
            # like [0, 2, ..., 9]
            if isinstance(n, str) and n.lstrip("-").isdigit():
                return int(n)
            return n

        out: Dict[str, List[Any]] = {}
        for k, v in raw.items():
            if isinstance(v, str):
                out[k.lower()] = [coerce(n) for n in str2list(v)]
            elif isinstance(v, list):
                out[k.lower()] = [coerce(n) for n in v]
            else:
                raise TypeError(f"feature_group '{k}' must be str or list, got {type(v).__name__}")
        return out

    def _init_features(self, rows: List[List[str]]) -> List[Feature]:
        out: List[Feature] = []
        owner: Dict[str, str] = {}
        for row in rows:
            for feat in self._parse_row(row):
                if feat.name in owner:
                    raise ValueError(
                        f"feature name conflict: '{feat.name}' declared by both "
                        f"group '{owner[feat.name]}' and group '{feat.field_name}'")
                owner[feat.name] = feat.field_name
                out.append(feat)
        return out

    def _resolve_vocab_var(self, var: str, materialize: bool = True):
        if var not in self.vocabs_map:
            raise KeyError(f"vocab variable '${var}' not found in Variables.vocabs")
        value = self.vocabs_map[var]
        if isinstance(value, list):
            return value
        if isinstance(value, str):
            if not materialize:
                return value
            values = self.vocab_reader(value)
            self.vocabs_map[var] = values
            return values
        raise TypeError(f"vocab '${var}' must be list or path, got {type(value).__name__}")

    def _parse_row(self, row: List[str]) -> List[Feature]:
        if len(row) != len(self.field_names):
            raise ValueError(f"feature row {row} does not match fields {self.field_names}")
        d = dict(zip(self.field_names, row))

        group = str(d[self.field_names[0]]).lower()
        name_list = list(self.feature_group.get(group, [group]))
        name_list = _expand_ellipsis(name_list)
        if any(isinstance(n, int) for n in name_list) and not self.slot_map:
            raise ValueError(
                f"group '{group}' uses integer slots but no slot-map file was provided")
        for n in name_list:
            if isinstance(n, int) and n not in self.slot_map:
                raise KeyError(f"slot {n} of group '{group}' missing from slot map")

        declared_type = str(d["type"]).lower()
        name_type = [tuple(self.slot_map[n]) if isinstance(n, int) else (str(n), declared_type)
                     for n in name_list]

        tower = FeatureTower(str(d["tower"]).lower())
        deal = FeatureDeal(str(d["deal"]).lower())
        pooling = FeaturePooling(str(d["pooling"]).lower())
        working = str(d["working"]).lower() == "true"
        seeds = self.seeds if deal == FeatureDeal.Hashing else None
        raw_vocab = d["vocab"]
        dim = -1 if deal in NO_DIM_DEALS else \
            _int_cell(group, "embedding_dim", d["embedding_dim"])

        vocabs: Optional[Union[List[Any], str]] = None
        vocab_size = -1
        if deal in (FeatureDeal.Lookup, FeatureDeal.Discrete):
            vocabs, vocab_size = self._resolve_lookup_vocab(group, raw_vocab)
            if deal == FeatureDeal.Discrete and vocabs == AUTO_VOCAB:
                raise ValueError(
                    f"discrete feature '{group}' needs explicit bin "
                    f"boundaries (a list or $variable), not a bucket size")
        elif deal == FeatureDeal.Hashing:
            vocab_size = _int_cell(group, "vocab (bucket size)", raw_vocab)
            if vocab_size <= 0:
                raise ValueError(f"hashing bucket size must be > 0 for '{group}'")
        elif deal == FeatureDeal.BertEncode:
            v = str(raw_vocab)
            vocabs = self._resolve_vocab_var(v[1:], materialize=False) if v.startswith("$") else v
            if not vocabs or vocabs == "null":
                raise ValueError(f"bert_encode feature '{group}' needs a vocab path")
            if not isinstance(vocabs, str):
                # a token LIST (legal for lookup) would pass here but crash
                # the tokenizer at first batch deep in the decode pool —
                # fail at parse time instead
                raise ValueError(
                    f"bert_encode feature '{group}': vocab must be a file "
                    f"path string, got {type(vocabs).__name__}")

        max_len = int(self.max_len_map.get(group, self.default_max_len))
        return [Feature(name, group, ftype, tower, deal, vocab_size, dim, pooling,
                        working, vocabs, seeds, max_len)
                for name, ftype in name_type]

    def _resolve_lookup_vocab(self, group: str, raw: Any):
        """literal list -> vocabs; '$name' -> variable; int -> bucket/__AUTO__."""
        if isinstance(raw, list):
            return list(raw), len(raw)
        v = str(raw)
        if v.startswith("$"):
            vocabs = self._resolve_vocab_var(v[1:], materialize=True)
            return list(vocabs), len(vocabs)
        try:
            size = int(v)
        except ValueError:
            if v.lower() == "null":
                raise ValueError(
                    f"lookup/discrete feature '{group}' must declare a vocab "
                    f"(list, $variable, or positive bucket size)") from None
            if v in self.vocabs_map:
                raise ValueError(
                    f"feature '{group}' got bare vocab symbol '{v}'; "
                    f"did you mean '${v}'?") from None
            raise ValueError(f"unknown vocab symbol '{v}' for feature '{group}'") from None
        if size <= 0:
            raise ValueError(f"vocab size for '{group}' must be > 0 (got {size})")
        return AUTO_VOCAB, size

    # -------------------------------------------------------------- querying
    @property
    def train_features(self) -> List[Feature]:
        return [f for f in self.features if f.working]

    @property
    def train_feature_names(self) -> List[str]:
        return [f.name for f in self.features if f.working]

    @property
    def user_features(self):
        return self.get_tower_features("user")

    @property
    def user_feature_names(self):
        return self.get_tower_features("user", name_only=True)

    @property
    def ad_features(self):
        return self.get_tower_features("ad")

    @property
    def ad_feature_names(self):
        return self.get_tower_features("ad", name_only=True)

    @property
    def context_features(self):
        return self.get_tower_features("context")

    @property
    def context_feature_names(self):
        return self.get_tower_features("context", name_only=True)

    @property
    def labels(self):
        return self.get_tower_features("label")

    @property
    def label_names(self):
        return self.get_tower_features("label", name_only=True)

    def get_tower_features(self, tower: str, name_only: bool = False):
        t = FeatureTower(tower)
        return [f.name if name_only else f for f in self.train_features if f.tower == t]

    def get_deal_features(self, deal: str, name_only: bool = False):
        d = FeatureDeal(deal)
        return [f.name if name_only else f for f in self.train_features if f.deal == d]

    def _set_deal_attrs(self):
        # dynamic `{deal}_features` / `{deal}_feature_names` attributes
        # (reference features.py:351-355); computed lazily via properties is
        # cleaner but attribute parity matters for downstream code.
        for deal in FeatureDeal:
            if deal == FeatureDeal.Null:
                continue
            setattr(self, f"{deal.value}_features", self.get_deal_features(deal.value))
            setattr(self, f"{deal.value}_feature_names",
                    self.get_deal_features(deal.value, name_only=True))

    def refresh(self):
        """Recompute dynamic deal attributes after working-flag toggles."""
        self._set_deal_attrs()

    # `|` inside a filter value means OR (reference features.py:388-415)
    @staticmethod
    def _match(feature: Feature, name_rlike=None, field=None, tower=None, deal=None) -> bool:
        if name_rlike:
            try:
                matched = _re.search(name_rlike, feature.name)
            except _re.error as e:
                raise ValueError(
                    f"invalid name_rlike filter {name_rlike!r}: {e}") from e
            if not matched:
                return False
        if field and not any(feature.field_name == p for p in field.split("|")):
            return False
        if tower and not any(feature.tower == FeatureTower(p) for p in tower.split("|")):
            return False
        if deal and not any(feature.deal == FeatureDeal(p) for p in deal.split("|")):
            return False
        return True

    def feature_filter(self, name_rlike=None, field=None, tower=None, deal=None,
                       train_only: bool = True) -> List[Feature]:
        pool = self.train_features if train_only else self.features
        return [f for f in pool if self._match(f, name_rlike, field, tower, deal)]

    def feature_except(self, name_rlike=None, field=None, tower=None, deal=None,
                       train_only: bool = True) -> List[Feature]:
        pool = self.train_features if train_only else self.features
        keep = []
        for f in pool:
            if name_rlike and any(p in f.name for p in name_rlike.split("|")):
                continue
            if field and any(f.field_name == p for p in field.split("|")):
                continue
            if tower and any(f.tower == FeatureTower(p) for p in tower.split("|")):
                continue
            if deal and any(f.deal == FeatureDeal(p) for p in deal.split("|")):
                continue
            keep.append(f)
        return keep

    get_features = feature_filter

    def get_fields_map(self, name_rlike=None, tower=None, deal=None,
                       name_only=False, train_only=True) -> Dict[str, List[Any]]:
        out: Dict[str, List[Any]] = {}
        for f in self.feature_filter(name_rlike, None, tower, deal, train_only):
            out.setdefault(f.field_name, []).append(f.name if name_only else f)
        return out

    def get_fields_map_except(self, name_rlike=None, tower=None, deal=None,
                              name_only=False, train_only=True) -> Dict[str, List[Any]]:
        out: Dict[str, List[Any]] = {}
        for f in self.feature_except(name_rlike, None, tower, deal, train_only):
            out.setdefault(f.field_name, []).append(f.name if name_only else f)
        return out

    def get_fields(self, name_rlike=None, tower=None, deal=None, train_only=True):
        return list(self.get_fields_map(name_rlike, tower, deal, True, train_only))

    def get_fields_except(self, name_rlike=None, tower=None, deal=None, train_only=True):
        return list(self.get_fields_map_except(name_rlike, tower, deal, True, train_only))

    def get_feature(self, name: str) -> Feature:
        for f in self.train_features:
            if f.name == name:
                return f
        raise KeyError(f"feature '{name}' does not exist (or is not working)")

    def get_features_by_name(self, names: Optional[List[str]] = None,
                             prefix: str = "", suffix: str = "") -> List[Feature]:
        if names:
            return [f for f in self.train_features if f.name in names]
        if prefix:
            return [f for f in self.train_features if f.name.startswith(prefix)]
        if suffix:
            return [f for f in self.train_features if f.name.endswith(suffix)]
        raise ValueError("give exactly one of names / prefix / suffix")

    def contain(self, name: str) -> bool:
        return any(f.name == name for f in self.train_features)

    def contain_any(self, name: str) -> bool:
        """Name exists regardless of working flag — the lookup the ± toggles
        need (a '+name' must find the disabled feature it re-enables)."""
        return any(f.name == name for f in self.features)

    def contain_field_any(self, field: str) -> bool:
        return any(f.field_name == field for f in self.features)

    def contain_field(self, field: str) -> bool:
        return any(f.field_name == field for f in self.train_features)

    def contain_deal(self, deal: FeatureDeal) -> bool:
        return any(f.deal == deal for f in self.train_features)

    # -------------------------------------------------------------- toggles
    def _set_status(self, name: str = "", field: str = "", status: bool = True):
        if not (name or field):
            raise ValueError("give name or field")
        hit = False
        for f in self.features:
            if (name and f.name == name) or (field and f.field_name == field):
                f.working = status
                hit = True
        if not hit:
            raise KeyError(f"no feature matches name='{name}' field='{field}'")
        self.refresh()

    def set_feature_valid(self, name: str = "", field: str = ""):
        self._set_status(name, field, status=True)

    def set_feature_invalid(self, name: str = "", field: str = ""):
        self._set_status(name, field, status=False)

    # -------------------------------------------------------------- display
    def summary_rows(self, scale: str = "train"):
        feats = self.features if scale == "all" else self.train_features
        return [[f.name, f.field_name, f.tower.value, f.deal.value, f.type,
                 f.vocab_size, f.embedding_dim, f.pooling.value, f.max_len, f.working]
                for f in feats]
