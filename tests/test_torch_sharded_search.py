"""The mesh-sharded exact searchers (retrieval/sharded.py) at world 2 and
4 over gloo, against the JAX package's ShardedSearcher / ShardedSqSearcher
on meshes of 2 and 4 fake CPU devices, and against the exact answer.

  * Flat (cos, ip, l2) and SQ8 / SQbf16 (ip, l2, cos) from
    `index_factory(..., mesh=)`, on a corpus of 70,007 rows: every shard is
    large enough for the grouped tournament (the JAX rule: more than
    max(k + 1, 64) supergroups a shard) and the last shard's valid rows end
    inside a group; scores within 1e-5 of JAX's (f32 sums in another
    order), ids equal except between scores tied within that; the Flat ids
    are the exact top-k; every rank returns the same answer;
  * the k + 1 case: the true top-k planted one per supergroup in the last
    shard, where the +BIG boundary group competes for the slots: the exact
    set is found (scores near 250 held within 1e-4, a few f32 spacings);
  * a small corpus (the per-shard scan without the tournament);
  * an index saved at world 2 loads at world 4 with the same answers, and
    a pickle round trip keeps them; the factory's refusals.
"""
import numpy as np
import pytest

import _torch_dist
import _torch_dist_tasks as tasks
import _torch_parity as tp

N, D, K = 70_007, 16, 10


@pytest.fixture(scope="module")
def pool2(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 2)


@pytest.fixture(scope="module")
def pool4(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 4)


def _world(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, D).astype(np.float32),
            rng.randn(12, D).astype(np.float32))


def _jax(spec, metric, corpus, queries, k, world):
    import jax
    from jax.sharding import Mesh
    from recommendflow_tpu.retrieval import index_factory
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("items",))
    s = index_factory(D, spec, metric, mesh=mesh).train(corpus)
    sc, ids = s.search(queries, k, return_items=False)
    return np.asarray(sc), np.asarray(ids)


def _check(got, want, world, exact=None, atol=1e-5):
    for rank, (sc, ids, name, rows) in enumerate(got):
        np.testing.assert_array_equal(sc, got[0][0])
        np.testing.assert_array_equal(ids, got[0][1])
        tp.agree((sc, ids), want, atol=atol)
        if exact is not None:
            for r in range(len(ids)):
                assert set(ids[r]) == set(exact[r]), r


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("metric", ["cos", "ip", "l2"])
def test_sharded_flat_matches_jax(world, metric, pool2, pool4):
    corpus, queries = _world()
    pool = pool2 if world == 2 else pool4
    got = pool.run(tasks.sharded_search, "Flat", metric, corpus, queries, K)
    assert got[0][2] == "ShardedSearcher"
    assert got[0][3] // (16 * 16) > 64              # the tournament path
    assert (N - (world - 1) * got[0][3]) % 16      # the boundary straddles
    c, q = corpus.astype(np.float64), queries.astype(np.float64)
    if metric == "cos":
        c = c / np.linalg.norm(c, axis=1, keepdims=True)
    s = -((q[:, None, :] - c[None]) ** 2).sum(-1) if metric == "l2" else q @ c.T
    _check(got, _jax("Flat", metric, corpus, queries, K, world), world,
           exact=np.argsort(-s, axis=1)[:, :K])


@pytest.mark.parametrize("spec,metric,world", [
    ("SQ8", "ip", 2), ("SQ8", "l2", 4), ("SQbf16", "l2", 2),
    ("SQbf16", "cos", 4), ("SQ8", "cos", 2)])
def test_sharded_sq_matches_jax(spec, metric, world, pool2, pool4):
    corpus, queries = _world(seed=1)
    pool = pool2 if world == 2 else pool4
    got = pool.run(tasks.sharded_search, spec, metric, corpus, queries, K)
    assert got[0][2] == "ShardedSqSearcher"
    assert got[0][3] // (16 * 16) > 64
    _check(got, _jax(spec, metric, corpus, queries, K, world), world)


def test_boundary_group_cannot_displace_the_topk(pool4):
    """k = 60: every true top item in its own supergroup of the last
    shard, beside the +BIG boundary group (select_k = k + 1)."""
    corpus, _ = _world(seed=2)
    corpus *= 0.01
    q = np.random.RandomState(3).randn(1, D).astype(np.float32)
    qn = q[0] / np.linalg.norm(q[0])
    k = 60
    n_local = 17920                                  # 70,007 over 4 shards
    for j in range(k):
        corpus[3 * n_local + j * 256] = qn * (10.0 + j)
    got = pool4.run(tasks.sharded_search, "Flat", "ip", corpus, q, k)
    assert got[0][3] == n_local
    exact = set(np.argsort(-(corpus @ q[0]))[:k].tolist())
    assert set(got[0][1][0].tolist()) == exact
    # scores near 250: f32 spacing 3e-5
    _check(got, _jax("Flat", "ip", corpus, q, k, 4), 4, atol=1e-4)


def test_small_corpus_scans_each_shard(pool2):
    corpus, queries = _world(n=3005, seed=4)
    for spec in ("Flat", "SQ8"):
        got = pool2.run(tasks.sharded_search, spec, "ip", corpus, queries, K)
        assert got[0][3] == 1536                      # 512-row multiple
        _check(got, _jax(spec, "ip", corpus, queries, K, 2), 2)


@pytest.mark.parametrize("spec", ["Flat", "SQ8"])
def test_saved_at_world_2_loads_at_world_4(spec, pool2, pool4, tmp_path):
    corpus, queries = _world(n=9001, seed=5)
    path = str(tmp_path / f"{spec}.npz")
    a = pool2.run(tasks.sharded_search, spec, "l2", corpus, queries, K, path)
    b = pool4.run(tasks.sharded_search, spec, "l2", None, queries, K, None,
                  path)
    c = pool4.run(tasks.sharded_search, spec, "l2", corpus, queries, K, None,
                  None, "pickle")
    for got in (b, c):
        tp.agree(got[0][:2], a[0][:2], atol=1e-5)
    # the JAX package reads the file the port wrote
    from recommendflow_tpu.retrieval import TpuSearcher as JFlat
    from recommendflow_tpu.retrieval import SqSearcher as JSq
    j = (JSq if spec == "SQ8" else JFlat).load(path)
    tp.agree(j.search(queries, K, return_items=False), a[0][:2], atol=1e-4)


def test_factory_refusals():
    from recommendflow_tpu_torch.retrieval import index_factory
    with pytest.raises(ValueError, match="Flat and SQ"):
        index_factory(16, "IVF16", mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        index_factory(16, "Flat", mesh=object())
