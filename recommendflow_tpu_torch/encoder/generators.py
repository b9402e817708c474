"""Text-pair batch generators for encoder training (a copy of
`recommendflow_tpu/encoder/generators.py` on the port's `Tokenizer`; with
the same seed both copies give bit-equal batches).

Capability parity with backend/utils/generator.py:5-266 + encoder_utils.py:
27-34: pair/interleaved ("zipped") batching with the stride-2 query/doc
interleave the zipped losses expect (losses/match.py:unzip_embedding),
weighted variants, and the SBERT [a; b; |a-b|] interaction head merge.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from recommendflow_tpu_torch.encoder.tokenizer import Tokenizer


def _batch_indices(n: int, batch_size: int, shuffle: bool,
                   seed: Optional[int],
                   drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """Shared epoch order + fixed-size slicing for every generator.

    seed=None (the default) reshuffles from fresh OS entropy on EVERY
    call — re-creating the exhausted iterator each epoch gives a new
    order and new in-batch negative sets, like the reference generators'
    per-epoch reshuffle; pass an int for reproducible order."""
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size and drop_remainder:
            return
        yield idx


def pair_batches(queries: Sequence[str], docs: Sequence[str],
                 labels: Sequence[float], tokenizer: Tokenizer,
                 batch_size: int, max_len: int, *,
                 weights: Optional[Sequence[float]] = None,
                 shuffle: bool = True, seed: Optional[int] = None,
                 drop_remainder: bool = True) -> Iterator[dict]:
    """Yield {'query_tok','query_seg','doc_tok','doc_seg','label'[,'weight']}
    fixed-shape batches for two-tower encoder training. seed=None
    reshuffles every call/epoch; pass an int for reproducible order."""
    n = len(queries)
    assert len(docs) == n and len(labels) == n
    assert weights is None or len(weights) == n, \
        f"weights length {len(weights)} != {n} examples"
    for idx in _batch_indices(n, batch_size, shuffle, seed, drop_remainder):
        q_tok, q_seg = tokenizer.encode_batch([queries[i] for i in idx], max_len)
        d_tok, d_seg = tokenizer.encode_batch([docs[i] for i in idx], max_len)
        batch = {"query_tok": q_tok, "query_seg": q_seg,
                 "doc_tok": d_tok, "doc_seg": d_seg,
                 "label": np.asarray([labels[i] for i in idx], np.float32)}
        if weights is not None:
            batch["weight"] = np.asarray([weights[i] for i in idx], np.float32)
        yield batch


def zipped_batches(queries: Sequence[str], docs: Sequence[str],
                   labels: Sequence[float], tokenizer: Tokenizer,
                   batch_size: int, max_len: int, *,
                   shuffle: bool = True,
                   seed: Optional[int] = None) -> Iterator[dict]:
    """Stride-2 interleaved [q0; d0; q1; d1; ...] token batches — the layout
    the reference's zipped losses consume (match_zipped_losses.py:18-28 /
    generator.py interleave)."""
    for b in pair_batches(queries, docs, labels, tokenizer, batch_size,
                          max_len, shuffle=shuffle, seed=seed):
        n = len(b["label"])
        tok = np.empty((2 * n, max_len), np.int32)
        seg = np.empty((2 * n, max_len), np.int32)
        tok[0::2], tok[1::2] = b["query_tok"], b["doc_tok"]
        seg[0::2], seg[1::2] = b["query_seg"], b["doc_seg"]
        yield {"tok": tok, "seg": seg, "label": b["label"]}


def interact_batches(queries: Sequence[str], docs: Sequence[str],
                     labels: Sequence[float], tokenizer: Tokenizer,
                     batch_size: int, max_len: int, *,
                     weights: Optional[Sequence[float]] = None,
                     shuffle: bool = True,
                     seed: Optional[int] = None) -> Iterator[dict]:
    """Single-encoder cross-interaction batches: [CLS] q [SEP] d [SEP] with
    segment ids (generator.py interact mode); optional per-sample
    'weight' column for the weighted losses."""
    n = len(queries)
    assert len(docs) == n and len(labels) == n
    assert weights is None or len(weights) == n, \
        f"weights length {len(weights)} != {n} examples"
    for idx in _batch_indices(n, batch_size, shuffle, seed):
        tok, seg = tokenizer.encode_batch([queries[i] for i in idx], max_len,
                                          pairs=[docs[i] for i in idx])
        batch = {"tok": tok, "seg": seg,
                 "label": np.asarray([labels[i] for i in idx], np.float32)}
        if weights is not None:
            batch["weight"] = np.asarray([weights[i] for i in idx],
                                         np.float32)
        yield batch


def simbert_batches(pairs: Sequence[Sequence[str]], tokenizer: Tokenizer,
                    batch_size: int, max_len: int, *,
                    shuffle: bool = True,
                    seed: Optional[int] = None) -> Iterator[dict]:
    """SimBERT/UniLM seq2seq batches from similar-sentence pairs (parity:
    generator.py:136-178 SimbertDataGenerator): each (t1, t2) contributes
    BOTH orders — [CLS] t1 [SEP] t2 [SEP] and [CLS] t2 [SEP] t1 [SEP] —
    with REAL segment ids (0 for the source sentence, 1 for the target),
    which is exactly what the UniLM mask (TextEncoder(seq2seq=True)) and
    the in-batch CLS similarity loss consume. Rows are padded to 2*max_len
    like the reference's maxlen=max_len*2 encode. Malformed entries
    (len != 2) are skipped, as the reference does.

    Yields {'tok': [2B, 2*max_len] int32, 'seg': [2B, 2*max_len] int32};
    there is no label — SimBERT's targets are the segment-1 tokens
    themselves (LM) plus the in-batch pair structure (rows 2i and 2i+1 are
    mutual positives), see encoder/simbert.py.
    """
    good = [p for p in pairs if len(p) == 2]
    half = max(1, batch_size // 2)
    width = 2 * max_len
    for idx in _batch_indices(len(good), half, shuffle, seed):
        texts, pair_texts = [], []
        for i in idx:
            t1, t2 = good[i]
            texts += [t1, t2]
            pair_texts += [t2, t1]
        tok, seg = tokenizer.encode_batch(texts, width, pairs=pair_texts)
        yield {"tok": tok, "seg": seg}


def sbert_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[a; b; |a-b|] feature for an SBERT-style interaction classifier head
    (parity: encoder_utils.py:27-34 merge)."""
    return np.concatenate([a, b, np.abs(a - b)], axis=-1)


def timeout(seconds: float, fallback=None):
    """Decorator: run fn in a worker thread with a deadline; return
    `fallback` (or raise TimeoutError when fallback is None) on expiry
    (parity: encoder_utils.py:15-24 timeout decorator used for the remote
    encode fallback, bert_encoder.py:79-117)."""
    import functools
    import threading

    def deco(fn):
        # one fresh DAEMON thread per call: a single-worker pool would be
        # permanently poisoned by the first hung call (futures cannot be
        # cancelled once running, so every later call queues behind it and
        # times out too, and the non-daemon worker blocks interpreter exit)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            box = {}

            def run():
                try:
                    box["value"] = fn(*args, **kwargs)
                except BaseException as e:  # surfaced below
                    box["error"] = e

            t = threading.Thread(target=run, daemon=True)
            t.start()
            t.join(seconds)
            if t.is_alive():            # timed out; abandon the thread
                if fallback is None:
                    raise TimeoutError(f"{fn.__name__} exceeded {seconds}s")
                return fallback(*args, **kwargs) if callable(fallback) else fallback
            if "error" in box:
                raise box["error"]
            return box["value"]
        return wrapped
    return deco
