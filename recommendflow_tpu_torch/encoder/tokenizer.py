"""WordPiece tokenizer — the bert4keras Tokenizer replacement (a copy of
`recommendflow_tpu/encoder/tokenizer.py` on the port's `native.py`; both
copies give bit-equal batches).

Capability parity with the reference's tokenizer usage
(preprocess_layers.py:109-132 BertEncode, bert_encoder.py:223-283): load a
BERT vocab.txt, lowercase, whitespace+punctuation+CJK split, greedy
longest-match wordpiece with '##' continuations, [CLS]/[SEP] framing,
(token_ids, segment_ids) output with max_len truncation/padding.

Pure Python host-side (tokenization never touches the device).
"""
from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def load_vocab(path: str) -> Dict[str, int]:
    """vocab.txt: one token per line, id = line number (parity:
    config_parser/config_utils.py:98-107 load_vocab)."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            if token and token not in vocab:
                vocab[token] = i
    return vocab


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or
            0xF900 <= cp <= 0xFAFF or 0x20000 <= cp <= 0x2A6DF)


class Tokenizer:
    def __init__(self, vocab: Dict[str, int] | str, do_lower_case: bool = True,
                 max_wordpiece_len: int = 100):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.do_lower_case = do_lower_case
        self.max_wordpiece_len = max_wordpiece_len
        for tok in (PAD, UNK, CLS, SEP):
            if tok not in vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.pad_id = vocab[PAD]
        self.unk_id = vocab[UNK]
        self.cls_id = vocab[CLS]
        self.sep_id = vocab[SEP]

    # --------------------------------------------------------- basic split
    def _basic_tokens(self, text: str) -> List[str]:
        if self.do_lower_case:
            text = text.lower()
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        out: List[str] = []
        buf: List[str] = []

        def flush():
            if buf:
                out.append("".join(buf))
                buf.clear()

        for ch in text:
            if ch.isspace():
                flush()
            elif _is_punctuation(ch) or _is_cjk(ch):
                flush()
                out.append(ch)
            else:
                buf.append(ch)
        flush()
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_wordpiece_len:
            return [UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                cand = word[start:end]
                if start > 0:
                    cand = "##" + cand
                if cand in self.vocab:
                    piece = cand
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._basic_tokens(text):
            out.extend(self._wordpiece(word))
        return out

    # ------------------------------------------------------------- encode
    def encode(self, first: str, second: Optional[str] = None,
               maxlen: Optional[int] = None) -> Tuple[List[int], List[int]]:
        """-> (token_ids, segment_ids) with [CLS] a [SEP] (b [SEP]) framing
        (bert4keras Tokenizer.encode surface)."""
        ids_a = [self.vocab.get(t, self.unk_id) for t in self.tokenize(first)]
        ids_b = [self.vocab.get(t, self.unk_id) for t in self.tokenize(second)] \
            if second else []
        if maxlen:
            budget = maxlen - 2 - (1 if ids_b else 0)
            if ids_b:
                # longest-first truncation
                while len(ids_a) + len(ids_b) > budget:
                    (ids_a if len(ids_a) >= len(ids_b) else ids_b).pop()
            else:
                ids_a = ids_a[:budget]
        token_ids = [self.cls_id] + ids_a + [self.sep_id]
        segment_ids = [0] * len(token_ids)
        if ids_b:
            token_ids += ids_b + [self.sep_id]
            segment_ids += [1] * (len(ids_b) + 1)
        return token_ids, segment_ids

    @property
    def _native_handle(self):
        """Lazy handle into the native WordPiece fast path (native/
        recflow_native.cc:rf_wp_build); None without the library."""
        if not hasattr(self, "_native_handle_cached"):
            from recommendflow_tpu_torch import native
            handle = None
            if native.available():
                max_id = max(self.vocab.values())
                # id-indexed token list; gaps get tokens containing NUL,
                # which greedy matching over real input never produces
                toks = [f"\x00gap{i}\x00" for i in range(max_id + 1)]
                for t, i in self.vocab.items():
                    toks[i] = t
                handle = native.wp_build(toks, self.pad_id, self.unk_id,
                                         self.cls_id, self.sep_id,
                                         self.do_lower_case)
            self._native_handle_cached = handle
        return self._native_handle_cached

    def __getstate__(self):
        """The native handle is a bare index into a PER-PROCESS C++
        registry: pickled across processes it would dereference a stale
        (or out-of-range) slot — drop it and rebuild lazily on first use."""
        state = dict(self.__dict__)
        state.pop("_native_handle_cached", None)
        return state

    def encode_batch(self, texts: Sequence[str], maxlen: int,
                     pairs: Optional[Sequence[str]] = None):
        """-> (token_ids [N, maxlen], segment_ids [N, maxlen]) padded int32
        numpy arrays (the BertEncode layer contract,
        preprocess_layers.py:117-124, with static shapes for jit).

        ASCII texts without pairs take the threaded native C++ WordPiece
        (bit-identical to the Python path, ~25x faster); full-Unicode texts
        (NFD folding, CJK splits) and text pairs stay on Python."""
        import numpy as np
        if maxlen < 2:
            # [CLS] + [SEP] alone need 2 slots; the native path would write
            # past a narrower row (and the Python path mis-truncates)
            raise ValueError(f"encode_batch maxlen must be >= 2, got {maxlen}")
        tok = np.full((len(texts), maxlen), self.pad_id, dtype=np.int32)
        seg = np.zeros((len(texts), maxlen), dtype=np.int32)
        rest = range(len(texts))
        handle = self._native_handle if pairs is None else None
        if handle is not None:
            from recommendflow_tpu_torch import native
            is_ascii = [t.isascii() for t in texts]
            idx = [i for i, a in enumerate(is_ascii) if a]
            if idx:
                sub = native.wp_encode_batch(
                    handle, [texts[i] for i in idx], maxlen,
                    self.max_wordpiece_len)
                tok[idx] = sub
            rest = [i for i, a in enumerate(is_ascii) if not a]
        for i in rest:
            t, s = self.encode(texts[i], pairs[i] if pairs else None, maxlen=maxlen)
            tok[i, :len(t)] = t
            seg[i, :len(s)] = s
        return tok, seg

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv_vocab.get(int(i), UNK) for i in ids
                if int(i) not in (self.pad_id, self.cls_id, self.sep_id)]
        text = " ".join(toks).replace(" ##", "")
        return text


def build_demo_vocab(words: Sequence[str]) -> Dict[str, int]:
    """Tiny vocab for tests/demos: specials + single chars + given words."""
    tokens = [PAD, UNK, CLS, SEP, MASK]
    chars = sorted({c for w in words for c in w.lower()})
    tokens += chars + [f"##{c}" for c in chars]
    tokens += sorted({w.lower() for w in words})
    return {t: i for i, t in enumerate(dict.fromkeys(tokens))}
