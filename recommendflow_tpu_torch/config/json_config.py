"""Legacy JSON config loader (the counterpart of
`recommendflow_tpu/config/json_config.py`).

JSON configs where a key prefixed with '#' marks the entry for deletion
(commented-out config), plus the slot-map and BERT-vocab loaders
re-exported from their homes in the port.
"""
from __future__ import annotations

import json
from typing import Any, Dict

from recommendflow_tpu_torch.config.features import load_slot_map  # noqa: F401
from recommendflow_tpu_torch.encoder.tokenizer import load_vocab  # noqa: F401
from recommendflow_tpu_torch.utils.tables import print_kv


def _strip_deleted(tree: Any) -> Any:
    """Drop keys starting with '#' recursively ('#lr': ... is disabled)."""
    if isinstance(tree, dict):
        return {k: _strip_deleted(v) for k, v in tree.items()
                if not str(k).startswith("#")}
    if isinstance(tree, list):
        return [_strip_deleted(v) for v in tree]
    return tree


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        conf = json.load(f)
    return _strip_deleted(conf)


def print_conf(conf: Dict[str, Any], title: str = "Config") -> None:
    """The config as one key/value table, nested keys joined by '.'."""
    flat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(key, v)
            else:
                flat[key] = v
    walk("", conf)
    print_kv(flat, title=title)
