"""Where each feature's rows live, worked out from a configuration file.

A configuration's `features` list is in the order the system stacks its
tables: every sparse feature owns `hashes` member tables of `rows` rows
(row 0 of each is the pad row), and the member tables of one width `dim`
are stacked, in feature order and branch by branch, into one table per
width. A stacked table is stored as rows of `row_bytes` (512 bytes): where
`dim` divides the row's elements, P = elements / dim logical rows share one
stored row, and the stored row count is padded to a multiple of 256. The
row-wise Adagrad of the tables keeps one accumulator per stored row.

Nothing here imports the program: this is the benchmark's own reading of
the configuration.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import numpy as np

STORED_ROW_MULTIPLE = 256
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


@dataclass(frozen=True)
class Group:
    dim: int
    offsets: Dict[Tuple[str, int], int]   # (feature, branch) -> first row
    rows: int                             # logical rows before padding
    pack: int                             # logical rows per stored row
    stored_rows: int                      # after padding

    @property
    def logical_rows(self) -> int:
        return self.stored_rows * self.pack


class Layout:
    """The feature and table layout of one configuration file."""

    def __init__(self, config: Mapping):
        self.features: List[dict] = list(config["features"])
        self.labels: List[str] = list(config["labels"])
        self.table_dtype: str = config["precision"]["tables"]
        self.row_bytes: int = int(config["optimizer"]["tables"]["row_bytes"])
        self.by_name = {f["name"]: f for f in self.features}
        self.groups: Dict[int, Group] = {}
        lanes = self.row_bytes // ITEMSIZE[self.table_dtype]
        for dim in sorted({f["dim"] for f in self.sparse()}):
            offsets, acc = {}, 0
            for f in self.sparse():
                if f["dim"] != dim:
                    continue
                for h in range(f["hashes"]):
                    offsets[(f["name"], h)] = acc
                    acc += f["rows"]
            pack = lanes // dim if dim < lanes and lanes % dim == 0 else 1
            stored = -(-acc // pack)
            stored = -(-stored // STORED_ROW_MULTIPLE) * STORED_ROW_MULTIPLE
            self.groups[dim] = Group(dim, offsets, acc, pack, stored)

    def sparse(self) -> List[dict]:
        return [f for f in self.features if f["kind"] == "sparse"]

    def tower(self, tower: str) -> List[dict]:
        return [f for f in self.features if f["tower"] == tower]

    @staticmethod
    def width(f: Mapping) -> int:
        """A feature's pooled width in its tower's concatenation."""
        if f["kind"] == "sparse":
            return f["hashes"] * f["dim"]
        return f["max_len"]

    def tower_width(self, tower: str) -> int:
        return sum(self.width(f) for f in self.tower(tower))

    def input_width(self) -> int:
        return sum(self.width(f) for f in self.features)

    def global_ids(self, f: Mapping, ids: np.ndarray) -> np.ndarray:
        """Ids [B, H, L] of feature f -> rows of its width's stacked table."""
        g = self.groups[f["dim"]]
        offs = np.array([g.offsets[(f["name"], h)] for h in range(f["hashes"])],
                        dtype=np.int64)
        return ids.astype(np.int64) + offs[None, :, None]

    def group_ids(self, batch: Mapping[str, np.ndarray]
                  ) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
        """{dim: (global logical ids [N], not-pad mask [N])} of a batch, every
        sparse feature of that width together."""
        out: Dict[int, Tuple[List[np.ndarray], List[np.ndarray]]] = {}
        for f in self.sparse():
            ids = np.asarray(batch[f["name"]])
            gids, valid = out.setdefault(f["dim"], ([], []))
            gids.append(self.global_ids(f, ids).reshape(-1))
            valid.append(ids.reshape(-1) > 0)
        return {d: (np.concatenate(g), np.concatenate(v))
                for d, (g, v) in out.items()}
