"""The port's tokenizer, whitening and TextEncoderService against the JAX
package's, on the CPU.

* Token and segment id batches are bit-equal, on the native WordPiece path
  (ASCII texts) and on the Python path (forced, and for Unicode texts and
  pairs).
* VecsWhitening is a numpy copy: bitwise equal on equal inputs.
* `encode` of the port's service and the JAX service with the same
  variables: without whitening within atol 2e-5 (the TextEncoder bound of
  test_torch_text_encoder.py). With whitening each side fits its own
  statistics on its own vectors; whitening divides by the square roots of
  the covariance's eigenvalues, which magnifies the 2e-5 difference, so the
  unit-norm whitened vectors agree within 1e-3.
"""
import pickle

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)

from recommendflow_tpu.encoder import TextEncoderService as JaxService
from recommendflow_tpu.encoder import Tokenizer as JaxTokenizer
from recommendflow_tpu.encoder.tokenizer import build_demo_vocab
from recommendflow_tpu.retrieval.whitening import VecsWhitening as JaxWhitening
from recommendflow_tpu_torch import native
from recommendflow_tpu_torch.encoder import TextEncoderService, Tokenizer
from recommendflow_tpu_torch.retrieval.whitening import VecsWhitening

WORDS = ["hello", "world", "deep", "rank", "search", "click", "phone",
         "music", "video", "news", "store"]
ASCII = ["hello world", "Deep  RANK, search!", "", "clicks phones",
         "music video news store " * 6, "zzz unknown-word 42", "a.b,c"]
UNICODE = ["héllo wörld", "深度 排序 hello", "naïve café", "日本語 text"]
SIZES = dict(max_len=16, batch_size=4, model_dim=32, num_layers=2,
             num_heads=4, ffn_hidden=64)


@pytest.fixture(scope="module")
def vocab():
    v = build_demo_vocab(WORDS)
    extra = [c for c in "深度排序日本語" if c not in v]
    return {**v, **{c: len(v) + i for i, c in enumerate(extra)}}


def _python_path(tok):
    tok._native_handle_cached = None      # what a missing library gives
    return tok


@pytest.mark.parametrize("path", ["native", "python"])
def test_tokenizer_batches_bit_equal(vocab, path):
    jt, tt = JaxTokenizer(vocab), Tokenizer(vocab)
    if path == "python":
        jt, tt = _python_path(jt), _python_path(tt)
    elif not native.available():
        pytest.skip("the native library does not build here")
    for texts in (ASCII, UNICODE, ASCII + UNICODE):
        for maxlen in (2, 8, 16):
            a, b = jt.encode_batch(texts, maxlen), tt.encode_batch(texts, maxlen)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.int32
                np.testing.assert_array_equal(x, y)
    pairs = ["world rank", "深度", "", "video"] * 3
    texts = (ASCII + UNICODE)[:len(pairs)]
    for x, y in zip(jt.encode_batch(texts, 12, pairs=pairs),
                    tt.encode_batch(texts, 12, pairs=pairs)):
        np.testing.assert_array_equal(x, y)


def test_native_and_python_paths_agree(vocab):
    if not native.available():
        pytest.skip("the native library does not build here")
    fast = Tokenizer(vocab)
    slow = _python_path(Tokenizer(vocab))
    for x, y in zip(fast.encode_batch(ASCII, 10), slow.encode_batch(ASCII, 10)):
        np.testing.assert_array_equal(x, y)
    assert fast.decode(fast.encode("hello world")[0]) == "hello world"


def test_tokenizer_pickle_drops_native_handle(vocab):
    tok = Tokenizer(vocab)
    tok.encode_batch(["hello"], 8)
    clone = pickle.loads(pickle.dumps(tok))
    assert not hasattr(clone, "_native_handle_cached")
    np.testing.assert_array_equal(tok.encode_batch(["hello world"], 8)[0],
                                  clone.encode_batch(["hello world"], 8)[0])


@pytest.mark.parametrize("dim", [None, 5])
def test_whitening_bitwise(dim, tmp_path):
    x = np.random.RandomState(0).randn(40, 12).astype(np.float32) * 3 + 1
    a, b = JaxWhitening(dim).fit(x), VecsWhitening(dim).fit(x)
    np.testing.assert_array_equal(a.kernel, b.kernel)
    np.testing.assert_array_equal(a.bias, b.bias)
    for norm in (True, False):
        np.testing.assert_array_equal(a.transform(x, norm), b.transform(x, norm))
    b.save(str(tmp_path / "w.npz"))
    c = VecsWhitening.load(str(tmp_path / "w"))
    np.testing.assert_array_equal(c.kernel, b.kernel)


def _texts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, size=rng.randint(1, 9)))
            for _ in range(n)]


def _services(vocab, **kw):
    jax_svc = JaxService(JaxTokenizer(vocab), **SIZES, **kw)
    variables = jax.tree.map(np.asarray, jax_svc.variables)
    port = TextEncoderService(Tokenizer(vocab), variables=variables,
                              device="cpu", **SIZES, **kw)
    return jax_svc, port


@pytest.mark.parametrize("pooling", ["cls", "avg"])
def test_encode_matches_the_jax_service(vocab, pooling):
    texts = list(dict.fromkeys(_texts(30))) + ["深度 hello"]
    jax_svc, port = _services(vocab, pooling=pooling)
    for norm in (False, True):
        np.testing.assert_allclose(port.encode(texts, normalize=norm),
                                   jax_svc.encode(texts, normalize=norm),
                                   rtol=0, atol=2e-5)


def test_encode_with_whitening_matches_the_jax_service(vocab):
    texts = list(dict.fromkeys(_texts(200, seed=1)))
    jax_svc, port = _services(vocab, use_whitening=True, whitening_dim=8)
    a, b = port.encode(texts), jax_svc.encode(texts)
    assert a.shape == b.shape == (len(texts), 8)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_cache_empty_input_and_bare_string(vocab):
    svc = TextEncoderService(Tokenizer(vocab), device="cpu", cache_size=3,
                             **SIZES)
    first = svc.encode(["hello", "world rank", "hello"])
    np.testing.assert_array_equal(first[0], first[2])
    assert list(svc._cache) == ["hello", "world rank"]
    again = svc.encode(["world rank", "deep", "news", "hello"])
    np.testing.assert_array_equal(again[0], first[1])
    np.testing.assert_array_equal(again[3], first[0])
    assert len(svc._cache) == 3                      # LRU capacity holds
    assert svc.encode([]).shape == (0, SIZES["model_dim"])
    with pytest.raises(TypeError, match="list of texts"):
        svc.encode("hello world")


def test_batches_are_padded_to_one_shape(vocab, monkeypatch):
    svc = TextEncoderService(Tokenizer(vocab), device="cpu", **SIZES)
    shapes = []
    forward = svc.model.forward

    def spy(tok, seg, **kw):
        shapes.append(tuple(tok.shape))
        return forward(tok, seg, **kw)

    monkeypatch.setattr(svc.model, "forward", spy)
    texts = _texts(11, seed=3)
    out = svc._encode_raw(texts)                 # 3 batches of 4, the last padded
    assert out.shape == (11, SIZES["model_dim"])
    assert shapes == [(4, 16)] * 3
    np.testing.assert_array_equal(out[8:], svc._encode_raw(texts[8:]))


def test_warmup_does_not_fit_whitening(vocab):
    svc = TextEncoderService(Tokenizer(vocab), device="cpu", use_whitening=True,
                             whitening_dim=8, **SIZES)
    svc.warmup()
    assert not svc._whitening_fit and not svc._cache
    assert svc.encode([]).shape == (0, 8)
    with pytest.raises(ValueError, match="whitening auto-fit"):
        svc.encode(["hello"])
    out = svc.encode(_texts(12, seed=4))
    assert svc._whitening_fit and out.shape == (12, 8)


def test_save_load_weights_and_pickle_round_trip(vocab, tmp_path):
    texts = list(dict.fromkeys(_texts(40, seed=5)))
    svc = TextEncoderService(Tokenizer(vocab), device="cpu", seed=3,
                             use_whitening=True, **SIZES)
    ref = svc.encode(texts)
    d = str(tmp_path / "w")
    svc.save(d)
    other = TextEncoderService(Tokenizer(vocab), device="cpu", seed=9, **SIZES)
    assert np.abs(other.encode(texts) - ref).max() > 1e-3
    other.load_weights(d)
    assert other.use_whitening and other._whitening_fit
    np.testing.assert_array_equal(other.encode(texts), ref)
    clone = pickle.loads(pickle.dumps(svc))
    assert clone.device == torch.device("cpu")
    np.testing.assert_array_equal(clone.encode(texts), ref)
    clone._cache.clear()
    np.testing.assert_array_equal(clone.encode(texts), ref)
    # reloading weights without a whitening file drops the stale statistics
    fresh = str(tmp_path / "fresh")
    TextEncoderService(Tokenizer(vocab), device="cpu", **SIZES).save(fresh)
    svc.load_weights(fresh)
    assert not svc._whitening_fit and not svc._cache


def test_the_jax_variables_load_into_the_port_weights_dir(vocab, tmp_path):
    """A JAX service's variables written as the flattened .npz are the
    port's weights directory."""
    from recommendflow_tpu_torch.interop import save_variables_npz
    jax_svc = JaxService(JaxTokenizer(vocab), **SIZES, seed=4)
    d = tmp_path / "from_jax"
    d.mkdir()
    save_variables_npz(str(d / "variables.npz"),
                       jax.tree.map(np.asarray, jax_svc.variables))
    port = TextEncoderService(Tokenizer(vocab), device="cpu", **SIZES)
    port.load_weights(str(d))
    texts = _texts(9, seed=6)
    np.testing.assert_allclose(port.encode(texts), jax_svc.encode(texts),
                               rtol=0, atol=2e-5)
