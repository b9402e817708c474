"""FlatSearcher's distance metrics, `.npz` files and pickles against the JAX
package's TpuSearcher on the CPU.

* The six distance metrics (l_p at metric_arg 3) return the same ascending
  distances within 1e-5 (f32 sums over D in another order) and the same ids
  except among distances within 1e-5 of each other.
* A `.npz` written by either package loads in the other and searches alike;
  a pickle restores onto the device it names and raises where that device
  is absent.
"""
import pickle

import numpy as np
import pytest

import _torch_parity as tp  # noqa: F401  (pins torch threads)
from recommendflow_tpu.retrieval.flat import TpuSearcher
from recommendflow_tpu_torch.retrieval.flat import FlatSearcher

ATOL = 1e-5
METRICS = ["l1", "l_inf", "l_p", "brayCurtis", "canberra", "jensen_shannon"]


def _check(metric, jres, tres, ref):
    """ref: [Q, N] float64 distances of every item."""
    (js, ji), (ts, ti) = jres, tres
    assert ts.shape == js.shape and ti.shape == ji.shape
    np.testing.assert_allclose(ts, js, rtol=0, atol=ATOL)
    got = np.take_along_axis(ref, ti, axis=1)
    want = np.take_along_axis(ref, ji, axis=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.all(np.diff(ts, axis=1) >= 0)              # ascending


def _ref(metric, q, v, p=3.0):
    x, y = q[:, None, :].astype(np.float64), v[None].astype(np.float64)
    d = np.abs(x - y)
    if metric == "l1":
        return d.sum(-1)
    if metric == "l_inf":
        return d.max(-1)
    if metric == "l_p":
        return (d ** p).sum(-1)
    if metric == "brayCurtis":
        return d.sum(-1) / np.abs(x + y).sum(-1)
    if metric == "canberra":
        return (d / (np.abs(x) + np.abs(y))).sum(-1)
    m = 0.5 * (x + y)
    return 0.5 * (x * np.log(x / m) + y * np.log(y / m)).sum(-1)


@pytest.mark.parametrize("metric", METRICS)
def test_distance_metrics_match_jax(metric):
    rng = np.random.RandomState(0)
    corpus = rng.rand(1300, 24).astype(np.float32) + 0.05    # pads to 1536
    queries = rng.rand(9, 24).astype(np.float32) + 0.05
    j = TpuSearcher(24, metric, metric_arg=3.0).train(corpus)
    t = FlatSearcher(24, metric, metric_arg=3.0, device="cpu").train(corpus)
    assert t.metric == metric and t.metric_arg == 3.0
    _check(metric, j.search(queries, topk=7, return_items=False),
           t.search(queries, topk=7, return_items=False),
           _ref(metric, queries, corpus))


def test_distance_metric_blocks_and_int_metric(monkeypatch):
    """Query and item blocks smaller than the inputs give the same answer
    (the block bound keeps the [Qb, nb, D] temporary small); raw FAISS
    MetricType ints resolve."""
    import recommendflow_tpu_torch.retrieval.flat as tf
    rng = np.random.RandomState(1)
    corpus = rng.randn(700, 8).astype(np.float32)
    queries = rng.randn(33, 8).astype(np.float32)
    whole = FlatSearcher(8, 2, device="cpu").train(corpus)
    assert whole.metric == "l1"
    a = whole.search(queries, topk=5, return_items=False)
    monkeypatch.setattr(tf, "_DISTANCE_TEMP_ELEMS", 512 * 8 * 4)   # Qb = 4
    b = FlatSearcher(8, "l1", device="cpu").train(corpus).search(
        queries, topk=5, return_items=False)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="unknown FAISS MetricType"):
        FlatSearcher(8, 99, device="cpu")


@pytest.mark.parametrize("metric", ["cos", "l2", "canberra"])
def test_npz_crosses_both_ways(tmp_path, metric):
    rng = np.random.RandomState(2)
    corpus = rng.rand(900, 16).astype(np.float32) + 0.1
    queries = rng.rand(6, 16).astype(np.float32) + 0.1
    items = np.array([f"x{i}" for i in range(900)])
    j = TpuSearcher(16, metric).train(corpus, items=items)
    t = FlatSearcher(16, metric, device="cpu").train(corpus, items=items)
    j.save(str(tmp_path / "j.npz"))
    t.save(str(tmp_path / "t"))
    assert set(np.load(str(tmp_path / "t.npz")).files) == \
        set(np.load(str(tmp_path / "j.npz")).files)
    from_j = FlatSearcher.load(str(tmp_path / "j.npz"), device="cpu")
    from_t = TpuSearcher.load(str(tmp_path / "t"))
    for a, b in ((j, from_j), (t, from_t), (j, t)):
        ia, sa, xa = a.search(queries, topk=8)
        ib, sb, xb = b.search(queries, topk=8)
        np.testing.assert_allclose(sa, sb, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(ia, ib)


def test_pickle_keeps_the_device_by_name(tmp_path):
    rng = np.random.RandomState(3)
    corpus = rng.randn(500, 8).astype(np.float32)
    t = FlatSearcher(8, "l_p", metric_arg=1.5, device="cpu").train(corpus)
    before = t.search(corpus[:4], topk=3)
    t.dump(str(tmp_path / "s.pkl"))
    again = FlatSearcher.load_pickle(str(tmp_path / "s.pkl"))
    assert again.metric_arg == 1.5 and str(again.device) == "cpu"
    for x, y in zip(before, again.search(corpus[:4], topk=3)):
        np.testing.assert_array_equal(x, y)
    state = t.__getstate__()
    assert state["device"] == "cpu" and isinstance(state["_vecs"], np.ndarray)
    state["device"] = "cuda:7"          # absent here: no quiet move to the CPU
    with pytest.raises(RuntimeError, match="cuda:7"):
        pickle.loads(pickle.dumps(t)).__setstate__(state)
    empty = FlatSearcher(8, device="cpu")
    assert empty._is_empty()
    with pytest.raises(RuntimeError, match="empty"):
        empty.search(corpus[:1])
    with pytest.raises(RuntimeError, match="nothing to save"):
        empty.save(str(tmp_path / "e"))
