"""Synthetic inputs for the text encoder: a WordPiece vocabulary, ASCII texts
and a random BERT checkpoint in HuggingFace naming, all made from a seed.

No checkpoint ships with the repository, so the encoder path is driven with
these: `write_bert_files` writes `bert_config.json`, `pytorch_model.bin` and
`vocab.txt` into a directory, which `TextEncoderService.from_pretrained`
loads as it would a released checkpoint.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

# google-research/bert's bert_config.json for the BERT-Base releases, with
# the Chinese release's vocabulary size
BERT_BASE = dict(vocab_size=21128, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 hidden_act="gelu", layer_norm_eps=1e-12,
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 initializer_range=0.02)

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
_CONSONANTS = "bcdfghjklmnprstvwz"
_VOWELS = "aeiou"
_SYLLABLES = [c + v for c in _CONSONANTS for v in _VOWELS]   # 90


def make_vocab(size: int, seed: int = 0) -> List[str]:
    """`size` tokens: the specials, single characters and their '##'
    continuations, every two-syllable word and continuation, then sampled
    three-syllable words."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789") + list(".,!?'-")
    tokens = SPECIALS + chars + ["##" + c for c in chars[:36]]
    tokens += ["##" + s for s in _SYLLABLES]
    two = [a + b for a in _SYLLABLES for b in _SYLLABLES]
    tokens += two + ["##" + w for w in two]
    rng = np.random.RandomState(seed)
    three = [a + b + c for a, b, c in
             rng.choice(_SYLLABLES, size=(4 * size, 3))]
    tokens = list(dict.fromkeys(tokens + three))
    if len(tokens) < size:
        raise ValueError(f"cannot make a vocabulary of {size} tokens")
    return tokens[:size]


def make_texts(n: int, seed: int = 0, min_words: int = 3,
               max_words: int = 36) -> List[str]:
    """n distinct ASCII texts of min_words..max_words words of one to four
    syllables and some numbers: whole-word tokens and word pieces, from
    about 5 to past 64 tokens (a few are truncated at a max_len of 64)."""
    rng = np.random.RandomState(seed)
    out: Dict[str, None] = {}
    while len(out) < n:
        k = rng.randint(min_words, max_words + 1)
        lengths = rng.randint(1, 5, size=k)
        syl = rng.randint(0, len(_SYLLABLES), size=int(lengths.sum()))
        words, at = [], 0
        for w in lengths:
            words.append("".join(_SYLLABLES[s] for s in syl[at:at + w]))
            at += w
        if rng.rand() < 0.2:
            words.insert(rng.randint(len(words)), str(rng.randint(1000)))
        out[" ".join(words)] = None
    return list(out)


def random_bert_state_dict(config: Dict, seed: int = 0
                           ) -> Dict[str, torch.Tensor]:
    """A HuggingFace `BertModel` state dict of `config`'s shapes with random
    f32 values: weights and biases normal(0, initializer_range), LayerNorm
    scales 1 + normal(0, 0.05) and offsets normal(0, 0.05)."""
    g = torch.Generator().manual_seed(seed)
    std = float(config.get("initializer_range", 0.02))
    d, f = config["hidden_size"], config["intermediate_size"]

    def normal(*shape, s=std, mean=0.0):
        return torch.randn(shape, generator=g) * s + mean

    def dense(prefix, n_out, n_in):
        return {prefix + ".weight": normal(n_out, n_in),
                prefix + ".bias": normal(n_out)}

    def layer_norm(prefix):
        return {prefix + ".weight": normal(d, s=0.05, mean=1.0),
                prefix + ".bias": normal(d, s=0.05)}

    e = "embeddings."
    state = {e + "word_embeddings.weight": normal(config["vocab_size"], d),
             e + "position_embeddings.weight":
                 normal(config["max_position_embeddings"], d),
             e + "token_type_embeddings.weight":
                 normal(config["type_vocab_size"], d)}
    state.update(layer_norm(e + "LayerNorm"))
    for i in range(config["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            state.update(dense(p + "attention.self." + name, d, d))
        state.update(dense(p + "attention.output.dense", d, d))
        state.update(layer_norm(p + "attention.output.LayerNorm"))
        state.update(dense(p + "intermediate.dense", f, d))
        state.update(dense(p + "output.dense", d, f))
        state.update(layer_norm(p + "output.LayerNorm"))
    state.update(dense("pooler.dense", d, d))
    return state


def write_bert_files(directory: str, config: Dict = BERT_BASE,
                     seed: int = 0) -> Tuple[str, str, str]:
    """Write bert_config.json, a random pytorch_model.bin and vocab.txt of
    config["vocab_size"] tokens into `directory`; returns the three paths."""
    os.makedirs(directory, exist_ok=True)
    paths = tuple(os.path.join(directory, n) for n in
                  ("bert_config.json", "pytorch_model.bin", "vocab.txt"))
    with open(paths[0], "w") as f:
        json.dump(config, f, indent=1)
    torch.save(random_bert_state_dict(config, seed), paths[1])
    with open(paths[2], "w") as f:
        f.write("\n".join(make_vocab(config["vocab_size"], seed)) + "\n")
    return paths
