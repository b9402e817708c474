"""The port's text-pair batch generators (`encoder/generators.py`) against
the JAX package's: with the same seed every batch is bit-equal (the same
np.random.RandomState order, the same tokenizer ids), shuffled and
unshuffled, with and without per-sample weights and the remainder; the SBERT
merge equals JAX's; and `timeout` returns, falls back and raises as JAX's
does."""
import time

import numpy as np
import pytest

import _torch_parity as tp  # noqa: F401  (pins torch threads)

from recommendflow_tpu.encoder import Tokenizer as JaxTokenizer
from recommendflow_tpu.encoder import generators as jgen
from recommendflow_tpu_torch.encoder import Tokenizer, build_demo_vocab
from recommendflow_tpu_torch.encoder import generators as tgen

WORDS = ["red", "blue", "green", "cat", "dog", "bird", "fast", "slow",
         "hello", "world"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    n = 23
    queries = [" ".join(rng.choice(WORDS, size=rng.randint(1, 5)))
               for _ in range(n)]
    docs = [" ".join(rng.choice(WORDS, size=rng.randint(1, 7)))
            for _ in range(n)]
    labels = rng.randint(0, 2, n).astype(float).tolist()
    weights = rng.rand(n).tolist()
    vocab = build_demo_vocab(WORDS)
    return dict(queries=queries, docs=docs, labels=labels, weights=weights,
                tok=Tokenizer(vocab), jtok=JaxTokenizer(vocab))


def _same(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


ORDERS = [dict(shuffle=False), dict(shuffle=True, seed=0),
          dict(shuffle=True, seed=7)]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_pair_batches_equal_jax(data, order, weighted, drop_remainder):
    d = data
    kw = dict(order, drop_remainder=drop_remainder,
              weights=d["weights"] if weighted else None)
    _same(tgen.pair_batches(d["queries"], d["docs"], d["labels"], d["tok"],
                            5, 12, **kw),
          jgen.pair_batches(d["queries"], d["docs"], d["labels"], d["jtok"],
                            5, 12, **kw))


@pytest.mark.parametrize("order", ORDERS)
def test_zipped_batches_equal_jax(data, order):
    d = data
    _same(tgen.zipped_batches(d["queries"], d["docs"], d["labels"], d["tok"],
                              4, 10, **order),
          jgen.zipped_batches(d["queries"], d["docs"], d["labels"],
                              d["jtok"], 4, 10, **order))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("weighted", [False, True])
def test_interact_batches_equal_jax(data, order, weighted):
    d = data
    kw = dict(order, weights=d["weights"] if weighted else None)
    _same(tgen.interact_batches(d["queries"], d["docs"], d["labels"],
                                d["tok"], 6, 16, **kw),
          jgen.interact_batches(d["queries"], d["docs"], d["labels"],
                                d["jtok"], 6, 16, **kw))


@pytest.mark.parametrize("order", ORDERS)
def test_simbert_batches_equal_jax(data, order):
    d = data
    pairs = list(zip(d["queries"], d["docs"])) + [("only one",), ()]
    _same(tgen.simbert_batches(pairs, d["tok"], 6, 8, **order),
          jgen.simbert_batches(pairs, d["jtok"], 6, 8, **order))


def test_unseeded_shuffles_differ_between_calls(data):
    """seed=None reshuffles from fresh entropy each call, as JAX's does."""
    d = data
    orders = {tuple(b["label"].tolist()) for _ in range(6) for b in
              tgen.pair_batches(d["queries"], d["docs"], d["labels"],
                                d["tok"], 23, 8)}
    assert len(orders) > 1


def test_mismatched_lengths_are_refused(data):
    d = data
    with pytest.raises(AssertionError):
        list(tgen.pair_batches(d["queries"], d["docs"][:-1], d["labels"],
                               d["tok"], 4, 8))
    with pytest.raises(AssertionError, match="weights length"):
        list(tgen.interact_batches(d["queries"], d["docs"], d["labels"],
                                   d["tok"], 4, 8, weights=[1.0]))


def test_sbert_merge_equals_jax():
    rng = np.random.RandomState(3)
    a, b = rng.randn(4, 6).astype(np.float32), rng.randn(4, 6).astype(np.float32)
    got, ref = tgen.sbert_merge(a, b), jgen.sbert_merge(a, b)
    assert got.shape == (4, 18)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mod", [tgen, jgen], ids=["port", "jax"])
def test_timeout_returns_falls_back_and_raises(mod):
    """The three outcomes: the value in time, the fallback (a value or a
    callable of the same arguments) past the deadline, TimeoutError without
    one; an error inside the function reaches the caller."""
    @mod.timeout(5.0)
    def quick(x):
        return x + 1

    assert quick(1) == 2

    def slow(x):
        time.sleep(2.0)
        return x

    assert mod.timeout(0.05, fallback=-1)(slow)(3) == -1
    assert mod.timeout(0.05, fallback=lambda x: x * 10)(slow)(3) == 30
    with pytest.raises(TimeoutError, match="slow exceeded"):
        mod.timeout(0.05)(slow)(3)

    @mod.timeout(5.0)
    def bad():
        raise KeyError("inner")

    with pytest.raises(KeyError, match="inner"):
        bad()
