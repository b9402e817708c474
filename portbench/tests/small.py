"""Cells of the benchmark at sizes a CPU test run holds: every table cut
to a few hundred rows, small batches, pools and catalogues. The widths stay
as the configuration states them."""
from __future__ import annotations

import os
import re
from typing import Dict, Mapping

from portbench.harness.cell import BENCH_DIR, Cell, read_json

ROWS = 301


def small_config(name: str, rows: int = ROWS, batch: int = 32) -> Dict:
    cfg = read_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))
    for f in cfg["features"]:
        if f["kind"] == "sparse" and f["rows"] > rows:
            f["rows"] = rows
    text = cfg["port_conf"]["Features"]["features"]
    # hashing and lookup buckets (the 5th field of a packed line) -> rows - 1
    def cut(m):
        parts = m.group(0).split(",")
        if parts[3] in ("hashing", "lookup") and int(parts[4]) > rows - 1:
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
