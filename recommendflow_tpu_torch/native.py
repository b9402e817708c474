"""ctypes bindings for the native host-path kernels (native/recflow_native.cc).

Auto-builds with `make -C native` on first use when a toolchain is present;
every entry point has a bit-identical numpy fallback so the framework is
fully functional without the .so (tests cover equality).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "native")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("RECFLOW_NO_NATIVE"):
        return None
    so = os.path.join(_native_dir(), "librecflow_native.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", _native_dir()], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    if not os.path.exists(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.rf_hash_matrix.argtypes = [u8p, i32p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_uint64, u64p]
    lib.rf_hash_blob.argtypes = [u8p, i32p, ctypes.c_int64, ctypes.c_uint64, u64p]
    lib.rf_pad_csr_i64.argtypes = [i64p, i32p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, i64p, u8p]
    lib.rf_pad_csr_f32.argtypes = [f32p, i32p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_float, f32p]
    lib.rf_hash_column_padded.argtypes = [u8p, i32p, i32p, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_uint64,
                                          ctypes.c_int64,
                                          np.ctypeslib.ndpointer(
                                              np.int32, flags="C_CONTIGUOUS")]
    lib.rf_wp_build.argtypes = [u8p, i32p, ctypes.c_int64, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32]
    lib.rf_wp_build.restype = ctypes.c_int64
    lib.rf_wp_encode_batch.argtypes = [ctypes.c_int64, u8p, i64p,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, i32p, ctypes.c_int32]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def hash_matrix(mat: np.ndarray, lengths: np.ndarray, seed: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    out = np.empty(mat.shape[0], dtype=np.uint64)
    lib.rf_hash_matrix(mat, lengths, mat.shape[0], mat.shape[1],
                       ctypes.c_uint64(seed & (2**64 - 1)), out)
    return out


def hash_column_padded(blob: bytes, byte_splits: np.ndarray,
                       row_splits: np.ndarray, max_len: int, seed: int,
                       num_bins: int) -> Optional[np.ndarray]:
    """Fused ragged-string-column hash -> padded [n_rows, max_len] int32 ids
    (1-based, 0 = pad/missing). None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    blob_arr = np.frombuffer(blob, dtype=np.uint8) if len(blob) else \
        np.zeros(1, dtype=np.uint8)
    byte_splits = np.ascontiguousarray(byte_splits, dtype=np.int32)
    row_splits = np.ascontiguousarray(row_splits, dtype=np.int32)
    n_rows = len(row_splits) - 1
    out = np.empty((n_rows, max_len), dtype=np.int32)
    lib.rf_hash_column_padded(np.ascontiguousarray(blob_arr), byte_splits,
                              row_splits, n_rows, max_len,
                              ctypes.c_uint64(seed & (2**64 - 1)),
                              num_bins, out)
    return out


def pad_csr_i64(values: np.ndarray, row_splits: np.ndarray, max_len: int,
                pad_value: int = 0):
    lib = _load()
    assert lib is not None
    values = np.ascontiguousarray(values, dtype=np.int64)
    row_splits = np.ascontiguousarray(row_splits, dtype=np.int32)
    n = len(row_splits) - 1
    out = np.empty((n, max_len), dtype=np.int64)
    mask = np.empty((n, max_len), dtype=np.uint8)
    lib.rf_pad_csr_i64(values, row_splits, n, max_len, pad_value, out, mask)
    return out, mask.astype(bool)


def pad_csr_f32(values: np.ndarray, row_splits: np.ndarray, max_len: int,
                pad_value: float = -1.0) -> np.ndarray:
    lib = _load()
    assert lib is not None
    values = np.ascontiguousarray(values, dtype=np.float32)
    row_splits = np.ascontiguousarray(row_splits, dtype=np.int32)
    n = len(row_splits) - 1
    out = np.empty((n, max_len), dtype=np.float32)
    lib.rf_pad_csr_f32(values, row_splits, n, max_len, pad_value, out)
    return out


def wp_build(tokens, pad_id: int, unk_id: int, cls_id: int, sep_id: int,
             lowercase: bool) -> Optional[int]:
    """Load a WordPiece vocab into the native library; returns a handle or
    None when the library is unavailable. `tokens` must be ordered by id
    (id = position)."""
    lib = _load()
    if lib is None:
        return None
    enc = [t.encode("utf-8") for t in tokens]
    blob = b"".join(enc)
    offs = np.zeros(len(enc) + 1, dtype=np.int32)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    blob_arr = np.frombuffer(blob, dtype=np.uint8) if blob else \
        np.zeros(1, dtype=np.uint8)
    return int(lib.rf_wp_build(np.ascontiguousarray(blob_arr), offs,
                               len(enc), pad_id, unk_id, cls_id, sep_id,
                               1 if lowercase else 0))


def wp_encode_batch(handle: int, texts, maxlen: int,
                    max_wordpiece_len: int = 100,
                    n_threads: int = 4) -> np.ndarray:
    """ASCII texts -> [n, maxlen] int32 token ids via the native WordPiece
    fast path (caller guarantees ASCII-only; see encoder/tokenizer.py)."""
    lib = _load()
    assert lib is not None and handle is not None
    if maxlen < 2:
        # the C kernel writes [CLS]/[SEP] unconditionally at row[0]/row[1];
        # a narrower row would be heap corruption, not truncation
        raise ValueError(f"wp_encode_batch maxlen must be >= 2, got {maxlen}")
    enc = [t.encode("ascii") for t in texts]
    blob = b"".join(enc)
    offs = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    blob_arr = np.frombuffer(blob, dtype=np.uint8) if blob else \
        np.zeros(1, dtype=np.uint8)
    out = np.empty((len(enc), maxlen), dtype=np.int32)
    lib.rf_wp_encode_batch(handle, np.ascontiguousarray(blob_arr), offs,
                           len(enc), maxlen, max_wordpiece_len, out,
                           n_threads)
    return out
