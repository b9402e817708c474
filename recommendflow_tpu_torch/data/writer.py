"""ETL: raw CSV tables -> RFB record files.

Capability parity with the reference's utils/make_tfrecord.py:23-196 — per-deal
cell parsing (multi-value cells split on ',', '-1'/'' missing sentinels,
';'/'|' nested separators for serialized embeddings), per-file multiprocessing
fan-out — targeting the RFB columnar format instead of tf.train.Example.
"""
from __future__ import annotations

import glob
import multiprocessing as mp
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.config.proto import FeatureDeal
from recommendflow_tpu_torch.data.recordio import ColumnSpec, RecordWriter

MAX_PROCS = 64


def columns_for(conf: Configuration) -> List[ColumnSpec]:
    """Record columns follow the declared feature type (str stays str —
    hashing happens at read time so bucket size / seeds can change without
    re-running ETL; the reference bakes hashing into the graph instead)."""
    cols = []
    for f in conf.features.train_features:
        if f.deal == FeatureDeal.Image:
            # raw encoded image bytes (reference: bytes_list of the file's
            # contents, make_tfrecord.py:70-79); decoded at read time
            vtype = "bytes"
        else:
            vtype = {"int": "int", "float": "float", "str": "str"}[f.type]
        cols.append(ColumnSpec(f.name, vtype))
    return cols


def parse_cell(raw: Any, vtype: str, deal: FeatureDeal) -> List[Any]:
    """One CSV cell -> list of values (the universal list convention)."""
    if raw is None or (isinstance(raw, float) and np.isnan(raw)):
        return []
    if deal == FeatureDeal.Image:
        # cell = image file path (or already-encoded bytes); store raw bytes
        if isinstance(raw, bytes):
            return [raw]
        path = str(raw).strip()
        if path in ("", "-1"):
            return []
        with open(path, "rb") as f:
            return [f.read()]
    if isinstance(raw, (list, tuple, np.ndarray)):
        return list(raw)
    s = str(raw).strip()
    # "-1" is the missing sentinel for id-like deals of EVERY dtype
    # (DEFAULT_MAP, config/proto.py; reference: '-1'->'' padding,
    # make_tfrecord.py:36-41) — but a real value for numeric/embedding
    # columns. Without the deal gate a numeric-typed discrete feature's
    # missing cells would train a real bucket (ids<0 masking only exists on
    # the hashing/lookup paths).
    id_like = deal in (FeatureDeal.Hashing, FeatureDeal.Lookup,
                       FeatureDeal.Discrete, FeatureDeal.TokenId)
    # pandas to_csv renders an integer -1 sentinel as '-1.0' in float
    # columns — both spellings are the missing marker for id-like deals
    sentinels = ("-1", "-1.0") if id_like else ("-1",)
    if s == "" or (s in sentinels and (vtype == "str" or id_like)):
        return []
    if deal == FeatureDeal.BertEncode:
        # raw free text: commas are CONTENT, not separators — splitting
        # would silently truncate the text at its first comma (the reader
        # tokenizes the whole cell)
        return [s]
    if deal == FeatureDeal.Embedding:
        # serialized-embedding cells flatten the reference's ','/';'/'|'
        # 1/2/3-dim nesting (make_tfrecord.py:50-67) — the declared
        # max_len/dim reshapes at read time
        parts = [p for p in re.split(r"[,;|]", s) if p != ""]
    else:
        parts = [p for p in s.split(",") if p != ""]
    if id_like:
        parts = [p for p in parts if p not in sentinels]  # per-element
    if vtype == "int":
        # int(p) FIRST: the float round-trip silently corrupts 64-bit ids
        # above 2^53 (597305344234567891 -> ...936); fall back to
        # int(float(p)) only for decimal-formatted cells like '3.0'
        out = []
        for p in parts:
            try:
                out.append(int(p))
            except ValueError:
                out.append(int(float(p)))
        return out
    if vtype == "float":
        return [float(p) for p in parts]
    return parts


def convert_rows(conf: Configuration, rows: Sequence[Dict[str, Any]],
                 out_path: str, block_rows: int = 4096) -> int:
    """Write an iterable of raw row-dicts to one RFB file."""
    specs = columns_for(conf)
    feats = {f.name: f for f in conf.features.train_features}
    checked = False
    with RecordWriter(out_path, specs, block_rows=block_rows) as w:
        for row in rows:
            if not checked:
                # fail loudly on a header mismatch — row.get() of a missing
                # column would otherwise write an all-empty (all-pad) dataset
                # with no error anywhere downstream
                missing = [s.name for s in specs if s.name not in row]
                if missing:
                    raise KeyError(
                        f"source rows lack feature column(s) {missing}; "
                        f"available: {sorted(row)} (feature names are "
                        "lower-cased at config parse — check the CSV header "
                        "case)")
                checked = True
            rec = {}
            for spec in specs:
                f = feats[spec.name]
                rec[spec.name] = parse_cell(row.get(spec.name), f.type, f.deal)
            w.write_row(rec)
        return w.rows_written


def _convert_csv_file(args):
    conf_path, src, out_path = args
    import csv as csvlib
    conf = Configuration(conf_path)
    with open(src, newline="") as f:
        reader = csvlib.DictReader(f)
        n = convert_rows(conf, reader, out_path)
    return src, out_path, n


def output_names(srcs: Sequence[str]) -> List[str]:
    """Collision-free output basenames for a source list — deterministic,
    so the CSV-cache reader can predict them without re-running the
    writer. Dedup checks the ASSIGNED set (a bare counter could hand
    'base-1' to a duplicate while a real source named base-1 also claims
    it, interleaving two Pool workers into one corrupt file)."""
    assigned: List[str] = []
    taken = set()
    for src in srcs:
        base = os.path.splitext(os.path.basename(src))[0]
        name, n = base, 0
        while name in taken:
            n += 1
            name = f"{base}-{n}"
        taken.add(name)
        assigned.append(name)
    return assigned


def build_records(conf_path: str, src_pattern: str, out_dir: str,
                  num_procs: Optional[int] = None) -> List[str]:
    """Convert every CSV matching src_pattern into out_dir/*.rfb in parallel
    (process fan-out parity: make_tfrecord.py:176-195)."""
    srcs = sorted(glob.glob(src_pattern))
    if not srcs:
        raise FileNotFoundError(f"no source files match {src_pattern}")
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for src, name in zip(srcs, output_names(srcs)):
        jobs.append((conf_path, src, os.path.join(out_dir, name + ".rfb")))
    procs = min(num_procs or mp.cpu_count(), MAX_PROCS, len(jobs))
    if procs <= 1:
        results = [_convert_csv_file(j) for j in jobs]
    else:
        with mp.Pool(procs) as pool:
            results = pool.map(_convert_csv_file, jobs)
    return [out for _, out, _ in results]
