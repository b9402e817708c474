"""YAML configuration with `$variable` substitution and experiment matrix.

Capability parity with the reference's config_parser/configuration.py:16-270:
  - top-level sections Features / Variables / Networks / Task / Datasets /
    Train / Evaluate / Infer / Experiments (only Features is mandatory);
  - `$name` resolves to the first value found for key `name` anywhere in the
    (nested) config; a whole-token `$name` keeps the value's type, `$name`
    embedded in a string substitutes its str() with token boundaries at any
    punctuation except '_';
  - `features` / `experiments` are whitespace-separated lines of
    comma-separated fields;
  - experiments are rows over `experiment_fields` (first must be exp_id) and
    `active_experiment(exp_id)` applies `+feat`/`-feat` working-flag toggles.
"""
from __future__ import annotations

import string
from typing import Any, Dict, List, Optional

import yaml

from recommendflow_tpu_torch.config.features import Features
from recommendflow_tpu_torch.config.proto import FeatureDeal
from recommendflow_tpu_torch.utils.str_parser import str2dict, str2list

def is_punctuation(ch: str, except_chars: str = "_") -> bool:
    return (ch in string.punctuation or ch.isspace()) and ch not in except_chars


_MISSING = object()  # sentinel: distinguishes 'key absent' from 'key: null'


def _find_key(tree: Any, key: str) -> Any:
    """Depth-first search for the first value stored under `key` — lists
    included (substitution recurses into lists, so resolution must reach
    the same places), and the FIRST occurrence wins even when its value
    is an explicit null (falling through to a deeper same-named key
    silently picked the wrong value)."""
    if isinstance(tree, dict):
        if key in tree:
            return tree[key]
        for v in tree.values():
            found = _find_key(v, key)
            if found is not _MISSING:
                return found
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            found = _find_key(v, key)
            if found is not _MISSING:
                return found
    return _MISSING


class Configuration:
    """Parsed framework configuration.

    Exposes: .conf (substituted config tree), .features (Features),
    .networks (Networks section), .experiments ({exp_id: row dict}),
    .active_experiment(exp_id), .get_conf_value(key).
    """

    def __init__(self, config_path: Optional[str] = None,
                 conf: Optional[Dict[str, Any]] = None,
                 vocab_reader=None):
        if conf is None:
            if config_path is None:
                raise ValueError("give config_path or conf")
            with open(config_path) as f:
                conf = yaml.safe_load(f.read())
        self.conf = conf
        self._source_path = config_path  # for multiprocess re-loading
        if "Features" not in self.conf:
            raise KeyError("config must contain a top-level 'Features' section")

        self._split_packed_lines()
        self._substitute_tree(self.conf)

        slot_map_path = self.get_conf_value_or("slot_map", None)
        self.features = Features(
            self.conf,
            vocabs_map=self.get_conf_value_or("vocabs", {}) or {},
            seeds=self.get_conf_value_or("seeds", None),
            slot_map_path=slot_map_path,
            default_max_len=int(self.get_conf_value_or("default_max_len", 1) or 1),
            max_len_map=self.get_conf_value_or("max_len_map", {}) or {},
            vocab_reader=vocab_reader,
        )

        self.networks: Dict[str, Any] = self.conf.get("Networks") or {}
        self.exp_conf = self.conf.get("Experiments")
        self.experiment_field, self.experiments = self._init_experiments()
        self.need_parse_second = (self.features.contain_deal(FeatureDeal.Image)
                                  or self.features.contain_deal(FeatureDeal.Embedding))

    # ----------------------------------------------------------- properties
    @property
    def train_features(self):
        return self.features.train_features

    @property
    def train_feature_names(self):
        return self.features.train_feature_names

    # ------------------------------------------------------------- parsing
    def _split_packed_lines(self):
        """features/experiments sections are newline-packed CSV strings."""
        fsec = self.conf["Features"]
        if isinstance(fsec.get("features"), str):
            fsec["features"] = [[c.strip() for c in line.split(",")]
                                for line in fsec["features"].split()]
        esec = self.conf.get("Experiments")
        if esec is not None and isinstance(esec.get("experiments"), str):
            esec["experiments"] = [[c.strip() for c in line.split(",")]
                                   for line in esec["experiments"].split()]
        elif esec is not None and not esec.get("experiments"):
            esec["experiments"] = []

    def get_conf_value(self, key: str, dtype: Optional[type] = None) -> Any:
        found = _find_key(self.conf, key)
        if found is _MISSING or found is None:
            raise KeyError(f"could not find key '{key}' in configuration")
        return dtype(found) if dtype else found

    def get_conf_value_or(self, key: str, default: Any = None) -> Any:
        found = _find_key(self.conf, key)
        return default if found is _MISSING or found is None else found

    def _sub_value(self, v: Any) -> Any:
        """Whole-token `$name` keeps native type; embedded `$name` stringifies."""
        if not isinstance(v, str):
            return v
        bare = all(not is_punctuation(c, "_$") for c in v)
        # '$' in the tail means ADJACENT tokens ('$a$b') — string path,
        # never one whole-token name 'a$b'
        if bare and v.startswith("$") and "$" not in v[1:]:
            name = v[1:]
            with self._resolving_guard(name):
                return self._sub_value(self.get_conf_value(name))
        if "$" in v:
            return self._sub_str(v)
        return v

    def _resolving_guard(self, name: str):
        """Context manager catching cyclic $references with a clear error
        (Variables: {a: $b, b: $a} used to die in RecursionError)."""
        import contextlib

        @contextlib.contextmanager
        def guard():
            stack = getattr(self, "_resolving", None)
            if stack is None:
                stack = self._resolving = []
            if name in stack:
                raise ValueError(
                    "cyclic $variable reference: "
                    + " -> ".join([*stack, name]))
            stack.append(name)
            try:
                yield
            finally:
                stack.pop()
        return guard()

    def _sub_str(self, v: str) -> str:
        """Replace each `$name` token inside a string; names end at any
        punctuation other than '_'."""
        out: List[str] = []
        i, n = 0, len(v)
        while i < n:
            ch = v[i]
            if ch == "$":
                j = i + 1
                while j < n and not is_punctuation(v[j], "_"):
                    j += 1
                name = v[i + 1:j]
                if not name:
                    out.append("$")
                    i += 1
                    continue
                with self._resolving_guard(name):
                    val = self.get_conf_value(name)
                    if isinstance(val, str) and "$" in val:
                        val = self._sub_str(val)
                if not isinstance(val, (str, int, float, bool)):
                    raise TypeError(
                        f"'${name}' inside a string must resolve to a scalar, "
                        f"got {type(val).__name__}: {val!r}")
                out.append(str(val))
                i = j
            else:
                out.append(ch)
                i += 1
        return "".join(out)

    def _substitute_tree(self, tree: Any, _section: Optional[str] = None
                         ) -> Any:
        """Recursively substitute `$name` through dicts/lists in place.

        The packed Features.features / Experiments.experiments rows are left
        untouched here: feature rows use '$' for vocab variables that Features
        resolves itself, and experiment rows are substituted per-row at
        _init_experiments time. The skip applies ONLY inside those two
        top-level sections — an unrelated key that merely shares the name
        (e.g. Datasets: {features: "$cols"}) still substitutes.
        """
        if isinstance(tree, dict):
            for k, v in tree.items():
                if k in ("features", "experiments") \
                        and _section in ("Features", "Experiments"):
                    continue
                sec = k if _section is None else _section
                if isinstance(v, (dict, list)):
                    self._substitute_tree(v, _section=sec)
                else:
                    tree[k] = self._sub_value(v)
        elif isinstance(tree, list):
            for idx, v in enumerate(tree):
                if isinstance(v, (dict, list)):
                    self._substitute_tree(v, _section=_section)
                else:
                    tree[idx] = self._sub_value(v)
        return tree

    # --------------------------------------------------------- experiments
    def _parse_exp_cell(self, cell: str) -> Any:
        if not isinstance(cell, str):
            return cell
        if cell.startswith("{") and cell.endswith("}"):
            return str2dict(cell[1:-1])
        if (cell.startswith("[") and cell.endswith("]")) or \
           (cell.startswith("(") and cell.endswith(")")):
            return str2list(cell[1:-1], sep=";")
        return self._sub_value(cell)

    def _init_experiments(self):
        if not self.exp_conf or not self.exp_conf.get("experiments"):
            return [], {}
        fields = self.exp_conf["experiment_fields"]
        fields = str2list(fields) if isinstance(fields, str) else list(fields)
        if not fields or fields[0] != "exp_id":
            raise ValueError("experiment_fields must start with 'exp_id'")
        table: Dict[int, Dict[str, Any]] = {}
        for row in self.exp_conf["experiments"]:
            try:
                exp_id = int(row[0])
            except (TypeError, ValueError):
                raise ValueError(f"exp_id must be an int, got {row[0]!r}") from None
            if len(row) != len(fields):
                # dict(zip(...)) would silently drop extra cells or omit
                # trailing fields (e.g. a stale row missing 'lr' -> the
                # experiment trains with a default LR and no error)
                raise ValueError(
                    f"experiment row {exp_id}: {len(row)} cells for "
                    f"{len(fields)} experiment_fields {fields}")
            values = [exp_id] + [self._parse_exp_cell(c) for c in row[1:]]
            # later duplicate exp_ids override earlier rows (the reference's
            # pandas index keeps duplicates, which breaks .loc — see SURVEY §2.10)
            table[exp_id] = dict(zip(fields, values))
        return fields, table

    def active_experiment(self, exp_id: int) -> Dict[str, Any]:
        """Apply an experiment row: ±feature toggles (name first, then field),
        returning the row dict (reference configuration.py:76-102 semantics)."""
        if exp_id not in self.experiments:
            raise KeyError(f"experiment {exp_id} not found; have {sorted(self.experiments)}")
        # NOTE: toggles are CUMULATIVE across calls (reference
        # configuration.py:76-102 parity, pinned by
        # tests/test_config.py:test_experiments_and_toggles) — comparing
        # experiments in one process needs reset_features() between them
        if not hasattr(self, "_baseline_working"):
            self._baseline_working = {f.name: f.working
                                      for f in self.features.features}
        row = self.experiments[exp_id]
        toggles = row.get("features")
        if toggles is not None:
            if not isinstance(toggles, list):
                raise TypeError("experiment 'features' must be a list of ±names")
            for t in toggles:
                if not t:
                    continue
                sign, name = t[0], t[1:]
                if sign == "+":
                    if self.features.contain_any(name):
                        self.features.set_feature_valid(name=name)
                    else:
                        self.features.set_feature_valid(field=name)
                elif sign == "-":
                    if self.features.contain_any(name):
                        self.features.set_feature_invalid(name=name)
                    else:
                        self.features.set_feature_invalid(field=name)
                else:
                    raise ValueError(f"experiment feature toggle must start with +/-: '{t}'")
        self.need_parse_second = (self.features.contain_deal(FeatureDeal.Image)
                                  or self.features.contain_deal(FeatureDeal.Embedding))
        return dict(row)

    def reset_features(self):
        """Restore every feature's baseline working flag (as parsed from
        the config), undoing all accumulated experiment toggles — for
        comparing experiments in one process."""
        baseline = getattr(self, "_baseline_working", None)
        if baseline:
            for f in self.features.features:
                f.working = baseline.get(f.name, f.working)
            self.features.refresh()

    # -------------------------------------------------------------- display
    def print_features(self, scale: str = "train"):
        from recommendflow_tpu_torch.utils.tables import print_table
        print_table(
            self.features.summary_rows(scale),
            headers=["name", "field", "tower", "deal", "type", "vocab",
                     "dim", "pooling", "max_len", "working"],
            title=f"Features ({scale})")
