"""JAX-native input pipeline: record files -> fixed-shape device batches.

Replaces the reference's tf.data stack (backend/core/dataloader.py:155-578)
with a thread-prefetched numpy pipeline:
  * path resolution with YYYYMMDD dayno substitution + brace-glob patterns
    (parity: dataloader.py:92-152, utils/str_parser.py:70-117),
  * file-granularity shuffle / train-valid split / per-host sharding,
  * block decode (recordio) -> vectorized CSR -> padded [B, H, L] id arrays
    with host-side hashing / vocab lookup / bucketization (see schema.py),
  * fixed batch shapes (the jit contract) with a drop-remainder tail policy,
  * background-thread prefetch and optional device_put with a Sharding.

Strings never leave the host. Every emitted batch has identical shapes and
dtypes, so one jit compilation serves the whole epoch.
"""
from __future__ import annotations

import glob as globlib
import os
import queue
import random
import re
import tempfile
import threading
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from recommendflow_tpu_torch.config.configuration import Configuration
from recommendflow_tpu_torch.config.proto import FeatureDeal
from recommendflow_tpu_torch.data import recordio
from recommendflow_tpu_torch.data.hashing import hash_bucket_array
from recommendflow_tpu_torch.data.schema import (
    PAD_ID, BatchSchema, FeatureSlot, compile_schema, encode_discrete, encode_lookup,
)
from recommendflow_tpu_torch.utils.str_parser import str2dayno

Batch = Dict[str, np.ndarray]


# -------------------------------------------------------------------- paths
def expand_braces(pattern: str) -> List[str]:
    """'a{1,2}b' -> ['a1b', 'a2b'] (single brace group, like the dayno DSL)."""
    m = re.search(r"\{([^{}]*)\}", pattern)
    if not m:
        return [pattern]
    head, tail = pattern[:m.start()], pattern[m.end():]
    out: List[str] = []
    for part in m.group(1).split(","):
        out.extend(expand_braces(head + part + tail))
    return out


def resolve_paths(pattern: str,
                  dayno: Optional[str] = None,
                  shuffle: bool = False,
                  sample_ratio: float = 1.0,
                  seed: int = 0) -> List[str]:
    """Resolve a data pattern to concrete record files.

    `dayno` is a day-range DSL expression substituted into a 'YYYYMMDD'
    placeholder (parity: dataloader.py:364-414). Local filesystem only;
    HDFS-style URIs should be staged locally first (utils/hdfs.py).
    """
    if dayno:
        pattern = pattern.replace("YYYYMMDD", str2dayno(dayno, mode="patten"))
    files: List[str] = []
    for pat in expand_braces(pattern):
        if os.path.isdir(pat):
            pat = os.path.join(pat, "*")
        files.extend(sorted(globlib.glob(pat)))
    # one file can match several brace alternatives ('part{0,00}*') —
    # without dedup its rows would be counted and trained TWICE per epoch
    files = list(dict.fromkeys(f for f in files if os.path.isfile(f)))
    rng = random.Random(seed)
    if sample_ratio < 1.0:
        k = max(1, int(len(files) * sample_ratio))
        files = rng.sample(files, k)
        files.sort()
    if shuffle:
        rng.shuffle(files)
    return files


def split_files(files: Sequence[str], valid_ratio: float,
                seed: int = 0) -> Tuple[List[str], List[str]]:
    """File-granularity train/valid split (parity: dataloader.py:136-152)."""
    files = list(files)
    if valid_ratio <= 0 or len(files) < 2:
        return files, []
    rng = random.Random(seed)
    shuffled = files[:]
    rng.shuffle(shuffled)
    n_valid = max(1, int(len(files) * valid_ratio))
    valid = set(shuffled[:n_valid])
    return [f for f in files if f not in valid], [f for f in files if f in valid]


def shard_for_host(files: Sequence[str], host_id: int, num_hosts: int) -> List[str]:
    """Static per-host file sharding for multi-host input."""
    return [f for i, f in enumerate(files) if i % num_hosts == host_id]


# ---------------------------------------------------------- batch assembly
def _pad_csr(values: np.ndarray, splits: np.ndarray, max_len: int,
             pad_value, dtype) -> Tuple[np.ndarray, np.ndarray]:
    """CSR (flat values, row_splits) -> padded [n, max_len] + bool mask."""
    n = len(splits) - 1
    lengths = np.minimum(np.diff(splits), max_len)
    valid = np.arange(max_len)[None, :] < lengths[:, None]
    out = np.full((n, max_len), pad_value, dtype=dtype)
    if len(values):
        pos = splits[:-1, None] + np.arange(max_len)[None, :]
        pos = np.clip(pos, 0, len(values) - 1)
        gathered = np.asarray(values)[pos]
        out = np.where(valid, gathered, out)
    return out, valid


def _encode_slot(slot: FeatureSlot, values: np.ndarray,
                 splits: np.ndarray) -> np.ndarray:
    """One feature's block column -> device-ready array [n, ...]."""
    if slot.kind == "dense":
        out, _ = _pad_csr(values.astype(np.float32), splits, slot.max_len,
                          -1.0, np.float32)
        return out

    if slot.kind == "embedding":
        # pre-serialized embedding vectors: float list of length max_len per
        # row (the reference's serialize_tensor columns, make_tfrecord.py:
        # 50-67 / dataloader.py:60-89 second parse), zero-filled when missing
        out, _ = _pad_csr(values.astype(np.float32), splits, slot.max_len,
                          0.0, np.float32)
        return out

    if slot.kind == "image":
        # decode jpeg/png/webp bytes host-side (PIL) -> [n, S, S, 3] float32
        # in [0, 1]; missing rows -> zeros (reference second-pass decode,
        # dataloader.py:60-89). Strings never reach the device; pixels do.
        return _decode_images(values, splits, slot.max_len)

    if slot.kind == "bert":
        # host-side tokenization of the raw text column -> token ids
        # ('<name>:seg' segment ids are produced by encode_block)
        from recommendflow_tpu_torch.data.schema import get_tokenizer
        tok = get_tokenizer(slot.vocab[0])
        texts, valid = _pad_csr(np.asarray(values, dtype=object), splits, 1,
                                "", object)
        ids, seg = tok.encode_batch([t if isinstance(t, str) else "" 
                                     for t in texts[:, 0]], slot.max_len)
        return np.stack([ids, seg], axis=0)  # [2, n, L] split by encode_block

    if slot.kind == "token":
        ids, valid = _pad_csr(values.astype(np.int64), splits, slot.max_len,
                              PAD_ID, np.int64)
        ids = np.where(ids < 0, PAD_ID, ids)  # -1 sentinel -> pad
        return np.where(valid, ids, PAD_ID).astype(np.int32)

    # sparse: hashing / lookup / discrete -> [n, H, L], ids 1-based, 0 = pad
    if slot.deal == FeatureDeal.Hashing:
        from recommendflow_tpu_torch import native
        from recommendflow_tpu_torch.data.recordio import StrColumn
        if isinstance(values, StrColumn) and native.available():
            # fused native path: blob -> padded 1-based ids, one pass per seed
            branches = [native.hash_column_padded(
                values.blob, values.byte_splits, splits, slot.max_len,
                seed, slot.num_rows - 1) for seed in slot.seeds]
            return np.stack(branches, axis=1)
        flat = np.asarray(values, dtype=object) \
            if not isinstance(values, np.ndarray) or values.dtype == object \
            else values
        miss = np.asarray([v in ("", "-1", None) for v in flat], dtype=bool) \
            if flat.dtype == object else (flat < 0)
        strs = [str(v) for v in flat]
        branches = []
        for seed in slot.seeds:
            ids = hash_bucket_array(strs, seed, slot.num_rows - 1) + 1
            ids[miss] = PAD_ID
            padded, valid = _pad_csr(ids, splits, slot.max_len, PAD_ID, np.int64)
            branches.append(np.where(valid, padded, PAD_ID))
        return np.stack(branches, axis=1).astype(np.int32)

    if slot.deal == FeatureDeal.Lookup:
        if slot.vocab is None:
            # __AUTO__ bucket: raw ints used directly, modulo table size
            ids = values.astype(np.int64)
            miss = ids < 0
            ids = ids % max(slot.num_rows - 1, 1) + 1
            ids[miss] = PAD_ID
        else:
            ids = encode_lookup(values, slot.vocab)
        padded, valid = _pad_csr(ids, splits, slot.max_len, PAD_ID, np.int64)
        return np.where(valid, padded, PAD_ID)[:, None, :].astype(np.int32)

    if slot.deal == FeatureDeal.Discrete:
        raw, valid = _pad_csr(values.astype(np.float64), splits, slot.max_len,
                              np.nan, np.float64)
        ids = encode_discrete(np.nan_to_num(raw, nan=0.0), slot.boundaries)
        ids = np.where(np.isnan(raw), PAD_ID, ids)
        return np.where(valid, ids, PAD_ID)[:, None, :].astype(np.int32)

    raise NotImplementedError(f"slot kind {slot.kind}/{slot.deal}")


def _decode_images(values, splits: np.ndarray, side: int) -> np.ndarray:
    """Ragged encoded-image column -> [n, side, side, 3] float32 in [0, 1]."""
    import io as iolib

    from PIL import Image

    n = len(splits) - 1
    out = np.zeros((n, side, side, 3), dtype=np.float32)
    blobs = values.materialize() if hasattr(values, "materialize") \
        else np.asarray(values, dtype=object)
    for i in range(n):
        if splits[i + 1] <= splits[i]:
            continue
        blob = blobs[splits[i]]
        if not blob:
            continue
        img = Image.open(iolib.BytesIO(blob)).convert("RGB")
        if img.size != (side, side):
            img = img.resize((side, side), Image.BILINEAR)
        out[i] = np.asarray(img, dtype=np.float32) / 255.0
    return out


def encode_block(schema: BatchSchema, block: Dict[str, recordio.ColumnValues],
                 perm: Optional[np.ndarray] = None) -> Batch:
    """Decode one record block into a dict of fixed-shape arrays."""
    out: Batch = {}
    for name in schema.order:
        slot = schema.slots[name]
        if name not in block:
            raise KeyError(f"record file missing column '{name}' required by config")
        values, splits = block[name]
        arr = _encode_slot(slot, values, splits)
        if slot.kind == "bert":
            ids, seg = arr[0], arr[1]
            out[name] = ids if perm is None else ids[perm]
            out[f"{name}:seg"] = seg if perm is None else seg[perm]
        else:
            out[name] = arr if perm is None else arr[perm]
    for name in schema.label_names:
        if name in block:
            values, splits = block[name]
            lab, _ = _pad_csr(values.astype(np.float32), splits, 1, 0.0, np.float32)
            arr = lab[:, 0]
            out[name] = arr if perm is None else arr[perm]
    return out


# ------------------------------------------------------------- the dataset
class Dataset:
    """Iterable of fixed-shape batches over a set of record files.

    debug/take semantics match the reference's `--train_mode test`
    (dataloader.py:578: dataset.take(10))."""

    def __init__(self,
                 schema: BatchSchema,
                 files: Sequence[str],
                 batch_size: int,
                 shuffle: bool = False,
                 seed: int = 0,
                 drop_remainder: bool = True,
                 take_batches: Optional[int] = None,
                 repeat: int = 1,
                 decode_workers: int = 0):
        self.schema = schema
        self.files = list(files)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.take_batches = take_batches
        self.repeat = repeat
        # >1: inflate+parse+hash blocks on a thread pool, order-preserving
        # (zlib / numpy / the native hash all release the GIL)
        self.decode_workers = decode_workers
        if not self.files:
            raise FileNotFoundError("dataset resolved to zero record files")

    def _iter_block_tasks(self, epoch_seed: int, skip_rows: int):
        """Yield (file_schema, nrows, comp, raw_size, perm, head_skip) decode
        tasks, cheaply skipping whole blocks from their headers without
        decode (O(1-block) mid-epoch resume, SURVEY §5). Permutations are
        drawn in iteration order so the shuffle stream is deterministic
        regardless of decode parallelism."""
        rng = np.random.RandomState(epoch_seed)
        files = self.files[:]
        if self.shuffle:
            rng.shuffle(files)
        remaining_skip = skip_rows
        for path in files:
            if remaining_skip > 0:
                # one header walk decides whole-file skip AND provides the
                # block sizes for the permutation burn (count_rows + a second
                # _iter_block_sizes pass would walk the headers twice)
                sizes = list(recordio.iter_block_nrows(path))
                total = sum(sizes)
                if remaining_skip >= total:
                    remaining_skip -= total
                    if self.shuffle:
                        # burn the per-file permutation draws to keep the
                        # epoch's shuffle stream identical to a full pass
                        for nrows in sizes:
                            rng.permutation(nrows)
                    continue
            file_schema = recordio.read_schema(path)
            for nrows, comp, raw_size in recordio.iter_raw_blocks(path):
                if remaining_skip >= nrows:
                    remaining_skip -= nrows
                    if self.shuffle:
                        rng.permutation(nrows)
                    continue
                perm = rng.permutation(nrows) if self.shuffle else None
                head = remaining_skip
                remaining_skip = 0
                yield path, file_schema, nrows, comp, raw_size, perm, head

    def _decode_task(self, task) -> Batch:
        path, file_schema, nrows, comp, raw_size, perm, head = task
        # decode only config-required columns; extras (toggled-off features,
        # surplus ETL columns) are skipped cheaply by the parser
        want = set(self.schema.order) | set(self.schema.label_names)
        block = recordio.decode_raw_block(comp, raw_size, file_schema, nrows, want)
        encoded = encode_block(self.schema, block, perm)
        # label columns are OPTIONAL (prediction files legitimately lack
        # them) but must be consistent ACROSS a dataset: a batch slicing
        # one labeled and one unlabeled block would misalign rows
        keys = frozenset(encoded)
        prev = getattr(self, "_block_keys", None)
        if prev is None:
            self._block_keys = keys
        elif keys != prev:
            raise ValueError(
                f"{path}: block columns {sorted(keys ^ prev)} inconsistent "
                "with earlier files — mixed labeled/unlabeled data in one "
                "pattern")
        if head > 0:
            encoded = {k: v[head:] for k, v in encoded.items()}
        return encoded

    def _iter_encoded_blocks(self, epoch_seed: int,
                             skip_rows: int = 0) -> Iterator[Batch]:
        tasks = self._iter_block_tasks(epoch_seed, skip_rows)
        if self.decode_workers <= 1:
            for task in tasks:
                yield self._decode_task(task)
            return
        # order-preserving pipelined pool
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(self.decode_workers) as pool:
            window: deque = deque()
            for task in tasks:
                window.append(pool.submit(self._decode_task, task))
                if len(window) > 2 * self.decode_workers:
                    yield window.popleft().result()
            while window:
                yield window.popleft().result()

    def __iter__(self) -> Iterator[Batch]:
        return self.iter_from(0)

    def _rows_per_rep(self) -> int:
        if not hasattr(self, "_rows_cache"):
            self._rows_cache = sum(recordio.count_rows(f) for f in self.files)
        return self._rows_cache

    def _batches_per_rep(self) -> int:
        rows = self._rows_per_rep()
        n = rows // self.batch_size
        if not self.drop_remainder and rows % self.batch_size:
            n += 1
        return n

    def iter_from(self, skip_batches: int = 0, epoch: int = 0) -> Iterator[Batch]:
        """Iterate starting `skip_batches` fixed-size batches into the
        (deterministically shuffled) stream — the resume entry point.

        `epoch` reshuffles: it folds into the per-rep shuffle seed, so each
        fit() epoch sees a different deterministic order and a resumed run
        reproduces it exactly. Skips are accounted in BATCHES per rep, so
        drop_remainder's discarded tail rows never desynchronize resume.
        """
        emitted = 0
        # take_batches bounds the ABSOLUTE stream position, so a resumed
        # iterator stops where the un-skipped one would (skipped batches
        # count as already emitted)
        already = skip_batches
        if self.take_batches and already >= self.take_batches:
            return
        per_rep = self._batches_per_rep()
        for rep in range(self.repeat):
            if skip_batches >= per_rep:
                skip_batches -= per_rep
                continue
            skip_rows = skip_batches * self.batch_size
            skip_batches = 0
            buf: List[Batch] = []
            buffered = 0
            rep_seed = self.seed + rep + 7919 * epoch
            for encoded in self._iter_encoded_blocks(rep_seed, skip_rows):
                buf.append(encoded)
                buffered += len(next(iter(encoded.values())))
                while buffered >= self.batch_size:
                    batch, buf, buffered = _slice_buffer(buf, self.batch_size)
                    yield batch
                    emitted += 1
                    if self.take_batches and already + emitted >= self.take_batches:
                        return
            if buf and not self.drop_remainder and buffered:
                batch, _, _ = _slice_buffer(buf, buffered)
                yield batch
                emitted += 1
            if self.take_batches and already + emitted >= self.take_batches:
                return

    def __len__(self) -> int:
        n = self._batches_per_rep() * self.repeat
        return min(n, self.take_batches) if self.take_batches else n


def _slice_buffer(buf: List[Batch], n: int) -> Tuple[Batch, List[Batch], int]:
    """Take the first n rows across buffered blocks; return remainder."""
    taken: Dict[str, List[np.ndarray]] = {}
    rest: List[Batch] = []
    need = n
    for blk in buf:
        size = len(next(iter(blk.values())))
        if need <= 0:
            rest.append(blk)
            continue
        if size <= need:
            for k, v in blk.items():
                taken.setdefault(k, []).append(v)
            need -= size
        else:
            head = {k: v[:need] for k, v in blk.items()}
            tail = {k: v[need:] for k, v in blk.items()}
            for k, v in head.items():
                taken.setdefault(k, []).append(v)
            rest.append(tail)
            need = 0
    batch = {k: np.concatenate(v, axis=0) if len(v) > 1 else v[0]
             for k, v in taken.items()}
    left = sum(len(next(iter(b.values()))) for b in rest)
    return batch, rest, left


def prefetch(it: Iterable[Batch], size: int = 2) -> Iterator[Batch]:
    """Background-thread prefetch (overlaps host decode with device step).

    Abandoning the returned generator (e.g. fit() breaking out mid-epoch on
    preemption) releases the worker: a plain blocking q.put would otherwise
    pin the thread plus size+1 decoded batches for the process lifetime."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _SENTINEL = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # propagate into consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


# --------------------------------------------------------------- top level
def make_dataset(conf: Configuration,
                 data_pattern: str,
                 batch_size: int,
                 dayno: Optional[str] = None,
                 shuffle: bool = True,
                 valid_ratio: float = 0.0,
                 seed: int = 0,
                 debug: bool = False,
                 host_id: int = 0,
                 num_hosts: int = 1,
                 repeat: int = 1,
                 drop_remainder: bool = True,
                 decode_workers: Optional[int] = None
                 ) -> Tuple[Dataset, Optional[Dataset]]:
    """Build (train, valid) Datasets from a config + data pattern.

    Parity surface: load_tfrecord_dayno_patten_split (dataloader.py:416-479)
    — dayno substitution, file split, debug truncation — with per-host
    sharding added for multi-host input. decode_workers defaults to
    the config's `thread_num` (the reference's tf.data reader-thread knob,
    dataloader.py:541-578).
    """
    schema = compile_schema(conf.features)
    if decode_workers is None:
        decode_workers = int(conf.get_conf_value_or("thread_num", 0) or 0)
    files = resolve_paths(data_pattern, dayno=dayno, seed=seed)
    files = shard_for_host(files, host_id, num_hosts)
    train_files, valid_files = split_files(files, valid_ratio, seed=seed)
    take = 10 if debug else None
    train = Dataset(schema, train_files, batch_size, shuffle=shuffle, seed=seed,
                    take_batches=take, repeat=repeat,
                    drop_remainder=drop_remainder,
                    decode_workers=decode_workers)
    valid = None
    if valid_files:
        valid = Dataset(schema, valid_files, batch_size, shuffle=False, seed=seed,
                        take_batches=take, drop_remainder=drop_remainder,
                        decode_workers=decode_workers)
    return train, valid


def multi_datasets(schema: BatchSchema, files: Sequence[str], batch_size: int,
                   files_per_dataset: int = 8, **kwargs
                   ) -> Iterator[Dataset]:
    """Generator of Datasets over successive file windows (parity:
    load_multi_tfrecord_datasets, dataloader.py:249-300) — e.g. one Dataset
    per ingest chunk for streaming prediction."""
    files = list(files)
    for start in range(0, len(files), files_per_dataset):
        chunk = files[start:start + files_per_dataset]
        if chunk:
            yield Dataset(schema, chunk, batch_size, **kwargs)


def multi_datasets_dict(schema: BatchSchema, pattern: str, batch_size: int,
                        dayno: Optional[str] = None, **kwargs
                        ) -> Dict[str, Dataset]:
    """Datasets keyed by the varying part of each matched path (parity:
    load_multi_tfrecord_datasets_dict, dataloader.py:482-538 glob-diff keys)
    — e.g. one Dataset per day directory."""
    if dayno:
        pattern = pattern.replace("YYYYMMDD", str2dayno(dayno, mode="patten"))
    groups: Dict[str, List[str]] = {}
    for pat in expand_braces(pattern):
        files = resolve_paths(pat)
        if files:
            groups[pat] = files
    if len(groups) <= 1 and groups:
        # no brace variation: key each file by its non-common part
        files = next(iter(groups.values()))
        prefix = os.path.commonprefix(files)
        groups = {f[len(prefix):] or os.path.basename(f): [f] for f in files}
    out: Dict[str, Dataset] = {}
    prefix = os.path.commonprefix(list(groups)) if len(groups) > 1 else ""
    for key, files in groups.items():
        out[key[len(prefix):] or key] = Dataset(schema, files, batch_size, **kwargs)
    return out


def load_csv_dataset(conf, csv_pattern: str, batch_size: int,
                     **kwargs) -> "Dataset":
    """Train directly from CSVs without an ETL step (parity: load_csv /
    make_csv_dataset, dataloader.py:155-197): CSVs are converted to a cached
    RFB mirror on first touch, then read through the normal pipeline."""
    import hashlib as _hashlib
    from recommendflow_tpu_torch.data.writer import build_records
    schema = compile_schema(conf.features)
    from recommendflow_tpu_torch.data.writer import columns_for as _cols
    # the deal is part of the signature: parse_cell's splitting/sentinel
    # behavior depends on it, so changing Lookup->BertEncode (same vtype)
    # must invalidate the cached parse
    deals = {f.name: f.deal.value for f in conf.features.train_features}
    spec_sig = ",".join(f"{c.name}:{c.vtype}:{deals.get(c.name, '')}"
                        for c in _cols(conf))
    cache_key = _hashlib.md5(f"{csv_pattern}|{spec_sig}".encode()).hexdigest()[:12]
    cache_dir = os.path.join(tempfile.gettempdir(), "recflow_csv_cache",
                             cache_key)
    srcs = sorted(globlib.glob(csv_pattern))
    if not srcs:
        raise FileNotFoundError(f"no CSVs match {csv_pattern}")
    # the writer's collision-free naming (duplicate basenames from
    # different directories become base-1, ...) — predicting bare
    # basenames here would silently read one duplicate twice forever
    from recommendflow_tpu_torch.data.writer import output_names
    expected = [os.path.join(cache_dir, name + ".rfb")
                for name in output_names(srcs)]
    if not all(os.path.exists(e) and os.path.getmtime(e) >= os.path.getmtime(s)
               for e, s in zip(expected, srcs)):
        if not getattr(conf, "_source_path", None):
            # writer needs a config path for subprocess workers; single-proc fallback
            from recommendflow_tpu_torch.data.writer import convert_rows
            import csv as _csv
            os.makedirs(cache_dir, exist_ok=True)
            for src, dst in zip(srcs, expected):
                with open(src, newline="") as f:
                    convert_rows(conf, _csv.DictReader(f), dst)
        else:
            build_records(conf._source_path, csv_pattern, cache_dir)
    return Dataset(schema, expected, batch_size, **kwargs)


def _iter_block_sizes(path: str) -> Iterator[Tuple[int, None]]:
    """Block row counts from headers only (delegates to recordio, which also
    validates block magic so corrupt files fail loudly)."""
    for nrows in recordio.iter_block_nrows(path):
        yield nrows, None
