"""Cells of the benchmark at sizes a CPU test run holds: every table cut
to a few hundred rows, small batches, pools and catalogues. The widths stay
as the configuration states them."""
from __future__ import annotations

import copy
import os
import re
from typing import Dict, Mapping, Optional

from portbench.harness.cell import BENCH_DIR, ROOT, Cell, read_json

ROWS = 301
# a small mesh cell's tables that the program row-shards (>= 8192 stored
# rows, which 2 and 4 ranks divide: 8448 each): dcn_criteo's widest table
# (dim 339, one logical row a stored row) and its packed dim-8 group (32
# logical rows a stored row)
MESH_ROWS = {"c03": 8300, "c09": 262500}


def small_config(name: str, rows: int = ROWS, batch: int = 32,
                 rows_of: Optional[Mapping[str, int]] = None) -> Dict:
    """The configuration cut to `rows` rows a table (a sparse feature in
    `rows_of` to its own rows) and batches of `batch`."""
    rows_of = dict(rows_of or {})
    cfg = read_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))
    for f in cfg["features"]:
        if f["kind"] == "sparse" and f["name"] in rows_of:
            f["rows"] = rows_of[f["name"]]
        elif f["kind"] == "sparse" and f["rows"] > rows:
            f["rows"] = rows
    text = cfg["port_conf"]["Features"]["features"]
    # hashing and lookup buckets (the 5th field of a packed line) -> rows - 1
    def cut(m):
        parts = m.group(0).split(",")
        if parts[3] not in ("hashing", "lookup"):
            return m.group(0)
        if parts[0] in rows_of:
            parts[4] = str(rows_of[parts[0]] - 1)
        elif int(parts[4]) > rows - 1:
            parts[4] = str(rows - 1)
        return ",".join(parts)
    cfg["port_conf"]["Features"]["features"] = re.sub(r"\S+", cut, text)
    cfg["batch_size"] = batch
    cfg["port_conf"]["Train"]["batch_size"] = batch
    return cfg


def small_traffic(name: str) -> Dict:
    t = read_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))
    if t["path"] == "fit":
        t.update(pool_batches=8, stack_steps=2, trace_stacks=2)
    else:
        t.update(rows=8, pool=6, sample=4, warmup=2,
                 trace_requests=5)
        if "catalogue" in t:
            t["catalogue"] = dict(t["catalogue"], items=2048, centres=16)
            t["topk"] = 10
    return t


def small_cell(workload: str, limits: Mapping = None, **kw) -> Cell:
    full = Cell(workload)
    return Cell(workload, config=small_config(full.workload["config"], **kw),
                traffic=small_traffic(full.workload["traffic"]),
                limits=limits if limits is not None else full.limits)


def mesh_cell(workload: str, chips: int, shard_tables: bool = True,
              small: bool = True, limits: Mapping = None,
              dropout: Optional[float] = 0.0) -> Cell:
    """A training cell on a mesh, in memory: `workload` on `chips` ranks with
    `"shard_tables"` in its configuration (at small sizes, with
    `MESH_ROWS`' tables big enough to shard; or at the cell's own), with
    `nccl_exposed_ms.train` among its per-layer metrics, and the model's
    `dropout` (none by default, as MLPerf's DLRM-DCNv2 has none:
    the program's ranks draw alike masks, PERF.md §7; None keeps the
    configuration's)."""
    bench = copy.deepcopy(read_json(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        if w["name"] == workload:
            w["chips"] = int(chips)
    # the per-layer entry a mesh cell's files would add beside the others
    bench["per_layer"].append({
        "name": "nccl_exposed_ms.train", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "mesh", "moves": "train_examples_per_s",
        "workloads": [workload]})
    full = Cell(workload, bench=bench)
    config = small_config(full.workload["config"], rows_of=MESH_ROWS) \
        if small else copy.deepcopy(full.config)
    config["shard_tables"] = bool(shard_tables)
    if dropout is not None:
        config["model_args"]["dropout"] = float(dropout)
    return Cell(workload, bench=bench, config=config,
                traffic=small_traffic(full.workload["traffic"]) if small
                else full.traffic,
                limits=limits if limits is not None else full.limits)
