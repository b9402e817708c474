"""FlatSearcher against the JAX package's TpuSearcher on all three search
paths, and the recall evaluation on top of it.

Scores agree to atol 1e-5 (f32 dot products summed in another order);
indices are equal except where two items' exact scores lie within 1e-5 of
each other (a tie, which the two top-k implementations may order either way).
"""
import numpy as np
import pytest

import _torch_parity as tp  # noqa: F401  (pins torch threads)
from recommendflow_tpu.retrieval.flat import TpuSearcher
from recommendflow_tpu_torch.retrieval import _kernels
from recommendflow_tpu_torch.retrieval.flat import FlatSearcher

ATOL = 1e-5


def _data(n, d, q, seed=0):
    rng = np.random.RandomState(seed)
    vecs = (rng.randn(n, d) / np.sqrt(d)).astype(np.float32)
    qs = (rng.randn(q, d) / np.sqrt(d)).astype(np.float32)
    return vecs, qs


def _exact(metric, qs, vecs, idx):
    """float64 score of each returned item (distance for l2)."""
    q = qs.astype(np.float64)
    v = vecs.astype(np.float64)
    if metric == "cos":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
    if metric == "l2":
        return np.sqrt(((q[:, None, :] - v[idx]) ** 2).sum(-1))
    return np.einsum("qd,qkd->qk", q, v[idx])


def _compare(metric, qs, vecs, jres, tres, items=None):
    (ji, js, jx), (ti, ts, tx) = jres, tres
    assert ts.shape == js.shape and tx.shape == jx.shape
    np.testing.assert_allclose(ts, js, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ti, tx if items is None else items[tx])
    differ = tx != jx
    ex_t, ex_j = _exact(metric, qs, vecs, tx), _exact(metric, qs, vecs, jx)
    assert np.abs(ex_t - ex_j)[differ].max(initial=0.0) <= ATOL
    assert all(len(set(r)) == len(r) for r in tx)
    return float(differ.mean())


def _both(metric, vecs, qs, k, **kw):
    j = TpuSearcher(vecs.shape[1], metric=metric, **kw).train(vecs)
    t = FlatSearcher(vecs.shape[1], metric=metric, device="cpu", **kw).train(vecs)
    assert t.num_items == j.num_items
    assert tuple(t._vecs.shape) == tuple(j._vecs.shape)
    return j.search(qs, topk=k), t.search(qs, topk=k), t


@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
def test_tournament_path(metric):
    n = _kernels._HIER_MIN_ITEMS + 5000       # pads to 327,680: a masked tail
    vecs, qs = _data(n, 128, 12, seed=1)
    jres, tres, t = _both(metric, vecs, qs, 100)
    n_pad = t._vecs.shape[0]
    assert n_pad == 327_680 and n_pad > n and \
        n_pad // (_kernels._GROUP * _kernels._SUPERGROUP) > 100
    _compare(metric, qs, vecs, jres, tres)


def test_single_level_prune_path():
    n, k = 300_000, 1300                       # n_pad 327,680: k > n_pad/256
    vecs, qs = _data(n, 16, 4, seed=2)
    jres, tres, t = _both("ip", vecs, qs, k)
    n_pad = t._vecs.shape[0]
    assert n_pad > 262144 and n_pad // 256 <= k < n_pad // 64
    _compare("ip", qs, vecs, jres, tres)


def test_plain_topk_path_with_list_topk():
    vecs, qs = _data(5000, 32, 20, seed=3)
    items = np.array([f"item{i}" for i in range(5000)])
    j = TpuSearcher(32, metric="l2").train(vecs, items=items)
    t = FlatSearcher(32, metric="l2", device="cpu").train(vecs, items=items)
    jr, tr = j.search(qs, topk=[5, 50]), t.search(qs, topk=[5, 50])
    for k in (5, 50):
        np.testing.assert_allclose(tr[1][k], jr[1][k], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(tr[0][k], items[tr[2][k]])
    _compare("l2", qs, vecs, (jr[0][50], jr[1][50], jr[2][50]),
             (tr[0][50], tr[1][50], tr[2][50]), items)
    # add() appends with FAISS semantics on both sides
    more, _ = _data(100, 32, 1, seed=4)
    j.add(more)
    t.add(more)
    assert t.num_items == j.num_items == 5100
    np.testing.assert_array_equal(t.items, j.items)
    _compare("l2", qs, np.concatenate([vecs, more]), j.search(qs, topk=20),
             t.search(qs, topk=20), t.items)


def test_recall_evaluation_matches():
    from recommendflow_tpu.retrieval import eval as jev
    from recommendflow_tpu_torch.retrieval import eval as tev
    rng = np.random.RandomState(5)
    n = 3000
    q = rng.randn(n, 16).astype(np.float32)
    items = rng.randn(400, 16).astype(np.float32)
    d = items[rng.randint(0, 400, n)]
    q = q + 2.0 * d                               # a learnable signal
    y = (rng.rand(n) > 0.3).astype(np.float32)
    jc, jl, jp = jev.build_eval_corpus(q, d, y)
    tc, tl, tpos = tev.build_eval_corpus(q, d, y)
    np.testing.assert_array_equal(jc, tc)
    np.testing.assert_array_equal(jl, tl)
    np.testing.assert_array_equal(jp, tpos)
    ks = tev.clamp_topk([5, 10, 50, 1000], len(tc))
    assert ks == jev.clamp_topk([5, 10, 50, 1000], len(jc)) == [5, 10, 50]
    jm = jev.batch_compute_recall_score(
        TpuSearcher(16, metric="cos").train(jc), q[jp], jl, ks, batch_size=700)
    tm = tev.batch_compute_recall_score(
        FlatSearcher(16, metric="cos", device="cpu").train(tc), q[tpos], tl, ks,
        batch_size=700)
    assert jm == tm
    assert tm["hit@50"] > 0.5
    assert tev.recall_report(tm, ks) == jev.recall_report(jm, ks)
    ranks = np.array([0, 3, 9, tev.MISS])
    w = np.array([1.0, 2.0, 0.5, 1.0])
    for name in ("hit_at_k", "mrr_at_k", "ndcg_at_k"):
        assert getattr(tev, name)(ranks, 5, w) == getattr(jev, name)(ranks, 5, w)
    np.testing.assert_array_equal(
        tev.click_ranks(np.array([[3, 1, 2], [7, 8, 9]]), np.array([1, 4])),
        jev.click_ranks(np.array([[3, 1, 2], [7, 8, 9]]), np.array([1, 4])))
