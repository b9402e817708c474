"""Pretrained BERT loading in the port against the JAX package and against
the HuggingFace forward, on the CPU.

The oracle is a tiny randomly initialised `transformers.BertModel` saved as
`pytorch_model.bin`, loaded by both packages' `load_pretrained_text_encoder`
(as tests/test_pretrained.py does for the JAX side). Port vs JAX within
1e-5 (the same weights; LayerNorm's variance formula and sums in another
order); port vs the HF forward within 1e-4 (the JAX package's bound against
the same oracle).
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)

transformers = pytest.importorskip("transformers")

from recommendflow_tpu.encoder.pretrained import \
    load_pretrained_text_encoder as jax_load  # noqa: E402
from recommendflow_tpu_torch.encoder import TextEncoderService  # noqa: E402
from recommendflow_tpu_torch.encoder.pretrained import (  # noqa: E402
    bert_encoder_kwargs, load_bert_checkpoint, load_pretrained_text_encoder)

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=48, type_vocab_size=2,
            hidden_act="gelu", layer_norm_eps=1e-12,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """(config.json path, .bin path, eval-mode BertModel)."""
    root = tmp_path_factory.mktemp("bert")
    cfg_path = os.path.join(root, "bert_config.json")
    with open(cfg_path, "w") as f:
        json.dump(TINY, f)
    torch.manual_seed(0)
    model = transformers.BertModel(transformers.BertConfig(**TINY)).eval()
    bin_path = os.path.join(root, "pytorch_model.bin")
    torch.save(model.state_dict(), bin_path)
    return cfg_path, bin_path, model


def _inputs(batch=3, length=10, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, TINY["vocab_size"], size=(batch, length))
    ids[:, 0] = 2
    ids[0, 7:] = 0
    ids[1, 9:] = 0
    seg = np.zeros_like(ids)
    seg[:, length // 2:] = 1
    seg[ids == 0] = 0
    return ids.astype(np.int32), seg.astype(np.int32)


def _hf_hidden(model, ids, seg):
    with torch.no_grad():
        out = model(input_ids=torch.tensor(ids.astype(np.int64)),
                    token_type_ids=torch.tensor(seg.astype(np.int64)),
                    attention_mask=torch.tensor((ids > 0).astype(np.int64)),
                    output_hidden_states=True)
    return [h.numpy() for h in out.hidden_states]


def _port(cfg, ckpt, ids, seg, **overrides):
    model, _ = load_pretrained_text_encoder(cfg, ckpt, device="cpu", **overrides)
    with torch.no_grad():
        return model(torch.from_numpy(ids), torch.from_numpy(seg)).numpy()


@pytest.mark.parametrize("overrides,hf_layer", [
    (dict(pooling="pos", pool_pos=0), -1),
    (dict(pooling="pos", pool_pos=0, out_layer=0), 1),
    (dict(pooling="avg"), -1)])
def test_port_matches_jax_and_the_hf_forward(oracle, overrides, hf_layer):
    cfg, ckpt, model = oracle
    ids, seg = _inputs()
    ours = _port(cfg, ckpt, ids, seg, **overrides)
    jm, jv = jax_load(cfg, ckpt, **overrides)
    np.testing.assert_allclose(
        ours, np.asarray(jm.apply(jv, jnp.asarray(ids), jnp.asarray(seg))),
        rtol=0, atol=1e-5)
    h = _hf_hidden(model, ids, seg)[hf_layer]
    if overrides["pooling"] == "avg":
        m = (ids > 0)[..., None]
        ref = (h * m).sum(1) / m.sum(1)
    else:
        ref = h[:, 0]
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_config_and_positional_clipping(oracle):
    cfg, ckpt, _ = oracle
    model, variables = load_pretrained_text_encoder(cfg, ckpt, max_len=16,
                                                    device="cpu")
    assert model.max_len == 16 and model.pos_emb.shape == (16, 32)
    assert variables["params"]["pos_emb"].shape == (16, 32)
    kwargs = bert_encoder_kwargs(cfg)
    assert kwargs["max_len"] == 48 and kwargs["ffn_activation"] == "gelu_exact"
    assert kwargs["ln_epsilon"] == 1e-12 and kwargs["pos_type"] == "learned"


def test_tf_checkpoint_needs_tensorflow(oracle, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)   # not installed
    with pytest.raises(ImportError, match="needs tensorflow"):
        load_bert_checkpoint(str(tmp_path / "bert_model.ckpt"))
    with pytest.raises(FileNotFoundError, match="cannot identify"):
        load_bert_checkpoint(str(tmp_path / "weights.xyz"))


def _write_vocab(path, n=TINY["vocab_size"]):
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    toks += [f"tok{i}" for i in range(n - len(toks))]
    path.write_text("\n".join(toks))
    return str(path)


def test_service_from_pretrained_matches_the_hf_forward(oracle, tmp_path):
    cfg, ckpt, model = oracle
    vocab = _write_vocab(tmp_path / "vocab.txt")
    svc = TextEncoderService.from_pretrained(cfg, ckpt, vocab, max_len=16,
                                             pool_pos=0, batch_size=4,
                                             device="cpu")
    texts = ["tok5 tok6", "tok7", "tok9 tok10 tok11"]
    embs = svc.encode(texts, normalize=False)
    tok, seg = svc.tokenizer.encode_batch(texts, 16)
    ref = _hf_hidden(model, tok, seg)[-1][:, 0]
    np.testing.assert_allclose(embs, ref, rtol=0, atol=1e-4)


def test_service_modes_and_validation(oracle, tmp_path):
    cfg, ckpt, _ = oracle
    vocab = _write_vocab(tmp_path / "vocab.txt")
    load = TextEncoderService.from_pretrained
    with pytest.raises(ValueError, match="pool_pos not support"):
        load(cfg, ckpt, vocab, pool_pos="first", device="cpu")
    with pytest.raises(ValueError, match="pool_pos scalar"):
        load(cfg, ckpt, vocab, pool_pos=999, device="cpu")
    with pytest.raises(ValueError, match="out_layer"):
        load(cfg, ckpt, vocab, out_layer=7, device="cpu")
    with pytest.raises(ValueError, match="model_weights_path"):
        load(cfg, ckpt, vocab, model_name="cosent", device="cpu")
    with pytest.raises(ValueError, match="unsupported model_name"):
        load(cfg, ckpt, vocab, model_name="interact", model_weights_path="x",
             device="cpu")
    # 'cosent': the checkpoint, then finetuned weights from `save` on top
    base = load(cfg, ckpt, vocab, max_len=16, device="cpu")
    with torch.no_grad():
        for p in base.model.parameters():
            p.add_(0.01)
    d = str(tmp_path / "finetuned")
    base.save(d)
    tuned = load(cfg, ckpt, vocab, model_name="cosent", model_weights_path=d,
                 max_len=16, device="cpu")
    a = tuned.encode(["tok9 tok10"], normalize=False)
    np.testing.assert_array_equal(a, base.encode(["tok9 tok10"], normalize=False))
    fresh = load(cfg, ckpt, vocab, max_len=16, device="cpu")
    assert np.abs(a - fresh.encode(["tok9 tok10"], normalize=False)).max() > 1e-4
