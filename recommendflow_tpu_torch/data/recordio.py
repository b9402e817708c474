"""RFB — a columnar block record format (the TFRecord replacement).

The reference serializes one tf.train.Example per row and pays a C++
proto-parse per record (utils/make_tfrecord.py:87-119,
backend/core/dataloader.py:23-89). For a device input pipeline the hot cost is
host-side decode throughput, so RFB stores *blocks* of rows in columnar
numpy-native layout: one zlib inflate + a handful of np.frombuffer calls
recovers thousands of rows with zero per-row Python work. Variable-length
(multi-hot) columns are CSR: flat values + int32 row_splits.

File layout:
    magic 'RFB1' | u32 schema_len | schema JSON (column names/types)
    repeat block:
        u32 0xB10C | u32 nrows | u32 comp_size | u32 raw_size | zlib payload
Block payload, per column in schema order:
    float  : i32 nvals | f32 values[nvals] | i32 row_splits[nrows+1]
    int    : i32 nvals | i64 values[nvals] | i32 row_splits[nrows+1]
    str    : i32 nvals | i32 nbytes | utf8 bytes | i32 byte_splits[nvals+1]
             | i32 row_splits[nrows+1]
    bytes  : same layout as str, payload is opaque binary (e.g. encoded
             images — the reference's raw-image bytes_list columns,
             make_tfrecord.py:70-79)
(All columns are lists — single-value columns are length-1 lists, matching
the reference's "everything is a list" convention, CONF_README.md:20.)
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"RFB1"
BLOCK_MAGIC = 0xB10C
DEFAULT_BLOCK_ROWS = 4096

ColumnValues = Tuple[np.ndarray, np.ndarray]  # (flat values, row_splits)


class _RaggedBlobColumn:
    """Lazy ragged column backed by one contiguous blob + byte offsets.

    Keeps the payload zero-copy so the native fused hash kernel
    (native/recflow_native.cc::rf_hash_column_padded) can consume the blob
    directly; indexing/iteration materializes python objects on demand via
    the subclass' _DECODE hook (one shared implementation so str and bytes
    columns can never drift apart)."""

    __slots__ = ("blob", "byte_splits", "_array")

    _DECODE = staticmethod(lambda b: b)

    def __init__(self, blob: bytes, byte_splits: np.ndarray):
        self.blob = blob
        self.byte_splits = byte_splits
        self._array = None

    def __len__(self) -> int:
        return len(self.byte_splits) - 1

    @property
    def dtype(self):
        return np.dtype(object)

    def materialize(self) -> np.ndarray:
        if self._array is None:
            bs = self.byte_splits
            arr = np.empty(len(self), dtype=object)
            blob = self.blob
            decode = self._DECODE
            for i in range(len(self)):
                arr[i] = decode(blob[bs[i]:bs[i + 1]])
            self._array = arr
        return self._array

    def __getitem__(self, idx):
        return self.materialize()[idx]

    def __iter__(self):
        return iter(self.materialize())

    def __array__(self, dtype=None, copy=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a


class StrColumn(_RaggedBlobColumn):
    """Lazy ragged string column: raw utf-8 blob + byte offsets."""

    __slots__ = ()

    _DECODE = staticmethod(lambda b: b.decode("utf-8"))


class BytesColumn(_RaggedBlobColumn):
    """Lazy ragged binary column (encoded images etc.): blob + byte offsets."""

    __slots__ = ()


@dataclass(frozen=True)
class ColumnSpec:
    name: str
    vtype: str  # 'float' | 'int' | 'str' | 'bytes'


class BlockBuilder:
    """Accumulates rows column-wise, emits one serialized block payload."""

    def __init__(self, columns: Sequence[ColumnSpec]):
        self.columns = list(columns)
        self.reset()

    def reset(self):
        self._values: Dict[str, List[Any]] = {c.name: [] for c in self.columns}
        self._splits: Dict[str, List[int]] = {c.name: [0] for c in self.columns}
        self._col_bytes: Dict[str, int] = {c.name: 0 for c in self.columns}
        self.nrows = 0

    @property
    def blob_bytes(self) -> int:
        """Accumulated blob bytes of the LARGEST str/bytes column: byte
        offsets are int32 in the block format, so each column blob must
        stay under 2^31 bytes — the writer flushes early on byte budget
        (a 4096-row block of ~1MB images would overflow a row-count-only
        flush policy)."""
        return max(self._col_bytes.values(), default=0)

    def add_row(self, row: Dict[str, Any]):
        for c in self.columns:
            vals = row.get(c.name, [])
            if vals is None:
                vals = []
            elif not isinstance(vals, (list, tuple, np.ndarray)):
                vals = [vals]
            if c.vtype in ("str", "bytes"):
                # encode NOW so the byte budget counts utf-8 BYTES (a char
                # count under-measures multibyte text up to 4x and the
                # int32 offset limit could be blown before the auto-flush)
                vals = [v if isinstance(v, bytes) else str(v).encode("utf-8")
                        for v in vals]
                self._col_bytes[c.name] += sum(len(v) for v in vals)
            self._values[c.name].extend(vals)
            self._splits[c.name].append(len(self._values[c.name]))
        self.nrows += 1

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        for c in self.columns:
            vals = self._values[c.name]
            splits = np.asarray(self._splits[c.name], dtype=np.int32)
            buf.write(struct.pack("<i", len(vals)))
            if c.vtype == "float":
                buf.write(np.asarray(vals, dtype=np.float32).tobytes())
            elif c.vtype == "int":
                buf.write(np.asarray(vals, dtype=np.int64).tobytes())
            elif c.vtype in ("str", "bytes"):
                encoded = [v if isinstance(v, bytes) else str(v).encode("utf-8")
                           for v in vals]
                blob = b"".join(encoded)
                if len(blob) > 2**31 - 1:
                    raise ValueError(
                        f"column '{c.name}': {len(blob)} blob bytes exceed "
                        "the int32 offset limit in one block — lower "
                        "block_rows (RecordWriter flushes on byte budget "
                        "for this automatically)")
                byte_splits = np.zeros(len(encoded) + 1, dtype=np.int32)
                if encoded:
                    np.cumsum([len(e) for e in encoded], out=byte_splits[1:])
                buf.write(struct.pack("<i", len(blob)))
                buf.write(blob)
                buf.write(byte_splits.tobytes())
            else:
                raise ValueError(f"unknown column vtype '{c.vtype}'")
            buf.write(splits.tobytes())
        return buf.getvalue()


class RecordWriter:
    """Streaming writer; call write_row / write_rows then close."""

    def __init__(self, path: str, columns: Sequence[ColumnSpec],
                 block_rows: int = DEFAULT_BLOCK_ROWS, compress_level: int = 1):
        self.path = path
        self.columns = list(columns)
        self.block_rows = block_rows
        self.compress_level = compress_level
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "wb")
        schema = json.dumps([[c.name, c.vtype] for c in self.columns]).encode("utf-8")
        self._f.write(MAGIC)
        self._f.write(struct.pack("<I", len(schema)))
        self._f.write(schema)
        self._builder = BlockBuilder(self.columns)
        self.rows_written = 0

    # flush well below the 2^31 int32-offset ceiling: decompression buffers
    # and the splits arrays add overhead on top of the blob itself
    MAX_BLOCK_BLOB_BYTES = 1 << 30

    def write_row(self, row: Dict[str, Any]):
        self._builder.add_row(row)
        self.rows_written += 1
        if (self._builder.nrows >= self.block_rows
                or self._builder.blob_bytes >= self.MAX_BLOCK_BLOB_BYTES):
            self._flush_block()

    def write_rows(self, rows: Sequence[Dict[str, Any]]):
        for r in rows:
            self.write_row(r)

    def write_columns(self, columns: Dict[str, List[Any]]):
        """Columnar bulk write: {name: list of per-row lists/scalars}."""
        if not columns:
            raise ValueError("write_columns: empty column dict")
        lens = {k: len(v) for k, v in columns.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"write_columns: unequal column lengths {lens}")
        n = len(next(iter(columns.values())))
        for i in range(n):
            self.write_row({k: v[i] for k, v in columns.items()})

    def _flush_block(self):
        if self._builder.nrows == 0:
            return
        raw = self._builder.serialize()
        comp = zlib.compress(raw, self.compress_level)
        self._f.write(struct.pack("<IIII", BLOCK_MAGIC, self._builder.nrows,
                                  len(comp), len(raw)))
        self._f.write(comp)
        self._builder.reset()

    def close(self):
        self._flush_block()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # do NOT flush/keep a half-written file: a valid-looking
            # partial .rfb would pass the CSV cache's mtime freshness
            # check forever and silently train on truncated data
            self._f.close()
            try:
                os.unlink(self.path)
            except OSError:
                pass
            return False
        self.close()


def read_schema(path: str) -> List[ColumnSpec]:
    with open(path, "rb") as f:
        if f.read(4) != MAGIC:
            raise ValueError(f"{path}: not an RFB1 record file")
        (n,) = struct.unpack("<I", f.read(4))
        schema = json.loads(f.read(n).decode("utf-8"))
    return [ColumnSpec(name, vtype) for name, vtype in schema]


def iter_raw_blocks(path: str) -> Iterator[Tuple[int, bytes, int]]:
    """Yield (nrows, compressed_payload, raw_size) per block — IO only, so
    inflate+parse can run on worker threads (zlib releases the GIL)."""
    with open(path, "rb") as f:
        f.seek(4)
        (n,) = struct.unpack("<I", f.read(4))
        f.seek(4 + 4 + n)
        while True:
            header = f.read(16)
            if len(header) < 16:
                if header:  # 1-15 bytes: a torn write, not a clean EOF
                    raise ValueError(
                        f"{path}: truncated block header ({len(header)} "
                        "bytes) — file was cut mid-write")
                break
            magic, nrows, comp_size, raw_size = struct.unpack("<IIII", header)
            if magic != BLOCK_MAGIC:
                raise ValueError(f"{path}: corrupt block header")
            yield nrows, f.read(comp_size), raw_size


def decode_raw_block(comp: bytes, raw_size: int, schema: Sequence[ColumnSpec],
                     nrows: int, want: set, path: str = "<block>"
                     ) -> Dict[str, ColumnValues]:
    raw = zlib.decompress(comp)
    if len(raw) != raw_size:
        raise ValueError(f"{path}: block size mismatch")
    return _parse_block(raw, schema, nrows, want)


def iter_blocks(path: str,
                columns: Optional[Sequence[str]] = None
                ) -> Iterator[Tuple[int, Dict[str, ColumnValues]]]:
    """Yield (nrows, {column: (flat_values, row_splits)}) per block.

    For str columns flat_values is an object ndarray of python strs.
    `columns` restricts decoding to a subset (others are skipped cheaply).
    """
    schema = read_schema(path)
    want = set(columns) if columns is not None else {c.name for c in schema}
    for nrows, comp, raw_size in iter_raw_blocks(path):
        yield nrows, decode_raw_block(comp, raw_size, schema, nrows, want, path)


def _parse_block(raw: bytes, schema: Sequence[ColumnSpec], nrows: int,
                 want: set) -> Dict[str, ColumnValues]:
    out: Dict[str, ColumnValues] = {}
    off = 0
    mv = memoryview(raw)
    splits_bytes = 4 * (nrows + 1)
    for c in schema:
        (nvals,) = struct.unpack_from("<i", raw, off)
        off += 4
        if c.vtype in ("float", "int"):
            itemsize = 4 if c.vtype == "float" else 8
            if c.name in want:
                dtype = np.float32 if c.vtype == "float" else np.int64
                values = np.frombuffer(mv[off:off + nvals * itemsize], dtype=dtype)
                splits = np.frombuffer(
                    mv[off + nvals * itemsize:off + nvals * itemsize + splits_bytes],
                    dtype=np.int32)
                out[c.name] = (values, splits)
            off += nvals * itemsize + splits_bytes
        elif c.vtype in ("str", "bytes"):
            (nbytes,) = struct.unpack_from("<i", raw, off)
            off += 4
            blob_start = off
            off += nbytes
            if c.name in want:
                byte_splits = np.frombuffer(mv[off:off + 4 * (nvals + 1)], dtype=np.int32)
                blob = mv[blob_start:blob_start + nbytes].tobytes()
                row_splits = np.frombuffer(
                    mv[off + 4 * (nvals + 1):off + 4 * (nvals + 1) + splits_bytes],
                    dtype=np.int32)
                col = StrColumn(blob, byte_splits) if c.vtype == "str" \
                    else BytesColumn(blob, byte_splits)
                out[c.name] = (col, row_splits)
            off += 4 * (nvals + 1) + splits_bytes
        else:
            raise ValueError(f"unknown vtype '{c.vtype}'")
    return out


def iter_block_nrows(path: str):
    """Row counts per block from headers only (no payload decode), with the
    same corruption check as the full readers."""
    with open(path, "rb") as f:
        f.seek(4)
        (n,) = struct.unpack("<I", f.read(4))
        f.seek(4 + 4 + n)
        while True:
            header = f.read(16)
            if len(header) < 16:
                if header:  # torn write, not clean EOF
                    raise ValueError(
                        f"{path}: truncated block header ({len(header)} "
                        "bytes) — file was cut mid-write")
                break
            magic, nrows, comp_size, _ = struct.unpack("<IIII", header)
            if magic != BLOCK_MAGIC:
                raise ValueError(f"{path}: corrupt block header")
            yield nrows
            f.seek(comp_size, 1)


def count_rows(path: str) -> int:
    return sum(iter_block_nrows(path))
