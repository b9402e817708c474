"""Host-side salted string hashing.

Device tensors have no string dtype, so the reference's in-graph `Hashing(salt)` layers
(preprocess_layers.py:79-106) move into the input pipeline: raw strings are
hashed on the host with two independently-salted 64-bit hashes ("double
hashing" for collision resistance) and only int32 bucket ids reach the
device. Config semantics are preserved: `deal=hashing` + bucket size +
Variables.seeds.

The hash is **rfhash64**: seeded FNV-1a over the UTF-8 bytes with a
splitmix64 avalanche finalizer. It is defined once and implemented three
times, bit-identically:
  * scalar Python (ground truth, hash64 below),
  * vectorized numpy over padded byte matrices (hash_bucket_array),
  * C (native/recflow_native.cc) loaded via ctypes when built.
Tests assert all implementations agree.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_GOLDEN = 0x9E3779B97F4A7C15
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
_MASK = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z &= _MASK
    z ^= z >> 30
    z = (z * _M1) & _MASK
    z ^= z >> 27
    z = (z * _M2) & _MASK
    z ^= z >> 31
    return z


def hash64(value: Union[str, bytes], seed: int) -> int:
    """rfhash64 of one string (scalar reference implementation)."""
    if isinstance(value, str):
        value = value.encode("utf-8")
    h = (_FNV_OFFSET ^ ((int(seed) * _GOLDEN) & _MASK)) & _MASK
    for b in value:
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return _splitmix64(h)


def hash_bucket(value: Union[str, bytes], seed: int, num_bins: int) -> int:
    return hash64(value, seed) % num_bins


def _to_byte_matrix(values: Sequence[Union[str, bytes]]):
    """Encode strings into a padded uint8 matrix + lengths (shared by the
    numpy and native paths)."""
    encoded = []
    for v in values:
        if isinstance(v, str):
            encoded.append(v.encode("utf-8"))
        elif isinstance(v, bytes):
            encoded.append(v)
        else:
            # bytes(int) is n ZERO bytes — stable-looking but heavily
            # colliding garbage; match scalar hash64's contract instead
            raise TypeError(
                f"hash input must be str/bytes, got {type(v).__name__} "
                f"({v!r}) — stringify id columns before hashing")

    lengths = np.fromiter((len(e) for e in encoded), count=len(encoded),
                          dtype=np.int32)
    max_len = int(lengths.max()) if len(encoded) else 0
    mat = np.zeros((len(encoded), max(max_len, 1)), dtype=np.uint8)
    for i, e in enumerate(encoded):
        mat[i, :len(e)] = np.frombuffer(e, dtype=np.uint8)
    return mat, lengths


def _hash_matrix(mat: np.ndarray, lengths: np.ndarray, seed: int) -> np.ndarray:
    """Vectorized rfhash64 over a padded byte matrix -> uint64 [n]."""
    n, max_len = mat.shape
    h = np.full(n, _FNV_OFFSET ^ ((int(seed) * _GOLDEN) & _MASK), dtype=np.uint64)
    prime = np.uint64(_FNV_PRIME)
    cols = mat.astype(np.uint64)
    for j in range(max_len):
        active = lengths > j
        h = np.where(active, (h ^ cols[:, j]) * prime, h)
    # splitmix64 finalizer (vectorized)
    h ^= h >> np.uint64(30)
    h *= np.uint64(_M1)
    h ^= h >> np.uint64(27)
    h *= np.uint64(_M2)
    h ^= h >> np.uint64(31)
    return h


def hash_bucket_array(values: Sequence[Union[str, bytes]],
                      seed: int,
                      num_bins: int) -> np.ndarray:
    """Bucket ids in [0, num_bins) for a flat list of strings -> int64 [n].

    Uses the native C batch hasher when built, else the vectorized numpy
    path; both are bit-identical to hash64."""
    if len(values) == 0:
        return np.zeros(0, dtype=np.int64)
    from recommendflow_tpu_torch import native
    mat, lengths = _to_byte_matrix(values)
    if native.available():
        h = native.hash_matrix(mat, lengths, seed)
    else:
        h = _hash_matrix(mat, lengths, seed)
    return (h % np.uint64(num_bins)).astype(np.int64)


def normalize_seeds(seeds: Union[int, Sequence[int], None],
                    num_hashes: int = 2) -> List[int]:
    """Expand a scalar seed into `num_hashes` distinct salts.

    Mirrors the reference convention (preprocess_layers.py:88: [s, s+7])
    while accepting explicit lists from Variables.seeds.
    """
    if seeds is None:
        seeds = 0
    if isinstance(seeds, str):
        # a YAML-quoted scalar ('seeds: "2022"') would otherwise iterate
        # as CHARACTERS -> salts [2, 0] instead of [2022, 2029], silently
        # hashing every feature differently from the unquoted config
        parts = [s for s in seeds.replace(",", " ").split() if s]
        if len(parts) == 1:
            seeds = int(parts[0])
        else:
            seeds = [int(s) for s in parts]
    if isinstance(seeds, int):
        return [seeds + 7 * i for i in range(num_hashes)]
    seeds = [int(s) for s in seeds]  # string entries from quoted YAML lists
    if not seeds:
        return normalize_seeds(0, num_hashes)   # [] -> documented default
    if len(seeds) < num_hashes:
        seeds = seeds + [seeds[-1] + 7 * (i + 1) for i in range(num_hashes - len(seeds))]
    return seeds[:num_hashes]
