"""The host-RAM search tier of the port (`retrieval/host_tier.py`:
StreamingSqSearcher, HostIvfSearcher) on the CPU.

* Counterparts of the 16 tests of tests/test_host_tier.py, on the port's
  classes, with the port's FlatSearcher and SqSearcher as the resident
  references.
* Against the JAX package's classes on the same numpy inputs:
  - f32 streaming: ids equal, scores within 1e-5, on the tiny-block path
    (full scores, top-k) and the hierarchical path (kernel 5's group
    maxima, the tournament);
  - bf16 / sq8: codes, ranges and xsq equal; on the hierarchical path the
    port forms the group maxima from bf16-rounded queries (as kernel 5 and
    the Pallas kernel do) where the JAX CPU path uses f32 ones, so an id in
    one top-k and not the other must score, over the dequantized corpus,
    within the rounding bound of the k-th best (the rule of
    tests/test_torch_sq.py); against the JAX kernel path (the Pallas kernel
    in interpret mode) the top-k are equal;
  - HostIvf with the JAX package's trained state carried across in its
    `.npz` (the k-means draws differ): the union scorer on both of its
    paths against JAX's;
  - `.npz` files both ways, JAX save -> port search and port save -> JAX
    load, for both classes, with equal search results.
* Tied scores may come out in another order than lax.top_k's, so tied ids
  are compared as sets.
"""
import functools

import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)
from recommendflow_tpu.ops.pallas.grouped_topk import grouped_score_max as pallas
from recommendflow_tpu.retrieval import HostIvfSearcher as JaxHostIvf
from recommendflow_tpu.retrieval import StreamingSqSearcher as JaxStreaming
from recommendflow_tpu_torch.retrieval import (FlatSearcher, HostIvfSearcher,
                                               SqSearcher,
                                               StreamingSqSearcher,
                                               index_factory)
from recommendflow_tpu_torch.retrieval import host_tier as th

CPU = dict(device="cpu")
SCORE_TOL = 1e-5
ATOL = 1e-4


def _corpus(n, d, seed=0):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def _clustered(n, d, n_cent=32, seed=20, spread=0.08):
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_cent, d).astype(np.float32)
    return centers[rng.randint(0, n_cent, n)] + \
        spread * rng.randn(n, d).astype(np.float32)


def _spy(monkeypatch):
    """Record (corpus dtype, rows, num_items) of each kernel-5 call of the
    host tier."""
    calls = []
    real = th.grouped_score_max

    def spy(q, v, sqn, **kw):
        calls.append((v.dtype, v.shape[0], kw["num_items"]))
        return real(q, v, sqn, **kw)

    monkeypatch.setattr(th, "grouped_score_max", spy)
    return calls


def _codes(x):
    """Host codes of either package as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _same_ids_up_to_ties(s, i, ref_s, ref_i, tol=SCORE_TOL):
    """Scores within tol position by position; ids equal as sets, except that
    an id whose score ties the k-th (within tol) may be swapped."""
    np.testing.assert_allclose(s, ref_s, rtol=tol, atol=tol)
    for r in range(len(i)):
        odd = set(i[r]) ^ set(ref_i[r])
        assert len(odd) <= 2 and (
            not odd or abs(s[r, -1] - ref_s[r, -1]) <= tol), (r, odd)


# ------------------------------------------------ counterparts of the 16
@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
def test_f32_streaming_matches_exact(metric):
    n, d, k = 5000, 16, 9
    v, q = _corpus(n, d, seed=1), _corpus(23, d, seed=2)
    exact = FlatSearcher(d, metric, **CPU).train(v)
    host = StreamingSqSearcher(d, metric, qtype="f32", block_items=1024,
                               **CPU).train(v)
    _, s1, i1 = exact.search(q, topk=k)
    _, s2, i2 = host.search(q, topk=k)
    np.testing.assert_allclose(s2, s1, rtol=1e-4, atol=1e-4)
    for r in range(len(q)):
        assert set(i2[r]) == set(i1[r]), r


@pytest.mark.parametrize("qtype", ["bf16", "sq8"])
@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
def test_quantized_streaming_matches_device_sq(metric, qtype):
    """The same quantizer as the resident SqSearcher: equal codes, and the
    same top-k up to selection ties (the resident item-block scan rounds
    the queries to bf16, the streamed fallback does not)."""
    n, d, k = 5000, 16, 9
    v, q = _corpus(n, d, seed=3), _corpus(17, d, seed=4)
    dev = SqSearcher(d, metric, qtype=qtype, **CPU).train(v)
    host = StreamingSqSearcher(d, metric, qtype=qtype, block_items=1024,
                               **CPU).train(v)
    np.testing.assert_array_equal(_codes(host._codes),
                                  _codes(dev._codes[:n]))
    _, s1, i1 = dev.search(q, topk=k)
    _, s2, i2 = host.search(q, topk=k)
    np.testing.assert_allclose(np.sort(s2, axis=1), np.sort(s1, axis=1),
                               rtol=1e-2, atol=1e-2)
    for r in range(len(q)):
        assert len(set(i2[r]) & set(i1[r])) >= k - 1


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_hier_block_path_is_exact(monkeypatch, metric):
    """Blocks large enough for the per-block tournament (block_items // 256
    >= k): kernel 5's plain version forms the group maxima (f32 form) and
    the merge returns exactly the brute-force top-k."""
    calls = _spy(monkeypatch)
    n, d, k = 20000, 16, 8
    v, q = _corpus(n, d, seed=13), _corpus(12, d, seed=14)
    host = StreamingSqSearcher(d, metric, qtype="f32", block_items=4096,
                               **CPU).train(v)
    s2, i2 = host.search(q, topk=k, return_items=False)
    assert calls == [(torch.float32, 4096, min(4096, n - s))
                     for s in range(0, n, 4096)]
    if metric == "l2":
        d2 = ((q[:, None, :] - v[None, :, :]) ** 2).sum(-1)
        golden = np.argsort(d2, axis=1)[:, :k]
        gs = np.sqrt(np.take_along_axis(d2, golden, axis=1))
    else:
        sim = q @ v.T
        golden = np.argsort(-sim, axis=1)[:, :k]
        gs = np.take_along_axis(sim, golden, axis=1)
    np.testing.assert_allclose(s2, gs, rtol=1e-4, atol=1e-4)
    for r in range(len(q)):
        assert set(i2[r]) == set(golden[r]), r


def test_blocked_train_and_add():
    n, d = 3000, 8
    v = _corpus(n, d, seed=5)
    whole = StreamingSqSearcher(d, "ip", qtype="sq8", block_items=256,
                                **CPU).train(v)
    blocks = StreamingSqSearcher(d, "ip", qtype="sq8", block_items=256,
                                 **CPU).train([v[:1000], v[1000:1700],
                                               v[1700:]])
    assert torch.equal(whole._codes, blocks._codes)
    np.testing.assert_array_equal(whole._vmin, blocks._vmin)
    extra = _corpus(500, d, seed=6)
    blocks.add(extra)
    assert blocks.num_items == n + 500
    assert torch.equal(blocks._codes[n:], whole._codes.new_tensor(
        np.clip(np.rint((extra - whole._vmin) / whole._scale), 0, 255)
        .astype(np.uint8)))
    _, idx = blocks.search(_corpus(5, d, seed=7), topk=3, return_items=False)
    assert idx.shape == (5, 3) and idx.min() >= 0


def test_topk_list_and_items():
    v = _corpus(2000, 8, seed=8)
    items = np.array([f"doc{i}" for i in range(2000)])
    s = StreamingSqSearcher(8, "cos", qtype="bf16", block_items=512,
                            **CPU).train(v, items=items)
    it, sc, idx = s.search(_corpus(4, 8, seed=9), topk=[3, 7])
    assert set(it) == {3, 7}
    assert it[3].shape == (4, 3) and sc[7].shape == (4, 7)
    assert it[3][0, 0].startswith("doc")
    np.testing.assert_array_equal(it[7], items[idx[7]])


def test_save_load_roundtrip(tmp_path):
    for qtype in ("bf16", "sq8", "f32"):
        v, q = _corpus(1500, 8, seed=10), _corpus(6, 8, seed=11)
        s = StreamingSqSearcher(8, "l2", qtype=qtype, block_items=512,
                                **CPU).train(v)
        s1, i1 = s.search(q, topk=5, return_items=False)
        path = str(tmp_path / f"host_{qtype}.npz")
        s.save(path)
        r = StreamingSqSearcher.load(path, **CPU)
        assert r._codes.dtype == s._codes.dtype
        s2, i2 = r.search(q, topk=5, return_items=False)
        np.testing.assert_array_equal(s2, s1)
        np.testing.assert_array_equal(i2, i1)


def test_index_factory_host_strings():
    s = index_factory(16, "HostSQbf16", metric="ip", **CPU)
    assert isinstance(s, StreamingSqSearcher) and s.qtype == "bf16"
    assert index_factory(16, "HostSQ8", **CPU).qtype == "sq8"
    s = index_factory(16, "HostFlat", metric="l2", **CPU)
    assert s.qtype == "f32" and s.metric == "l2"
    s = index_factory(16, "HostIVF64", **CPU)
    assert isinstance(s, HostIvfSearcher) and s.qtype == "sq8"
    with pytest.raises(ValueError, match="host tier"):
        index_factory(16, "HostFlat", mesh=object(), **CPU)


@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
@pytest.mark.parametrize("qtype", ["bf16", "sq8", "f32"])
def test_host_ivf_recall(metric, qtype):
    n, d, k = 8000, 16, 10
    v = _clustered(n, d)
    q = v[:40] + 0.03 * np.random.RandomState(21).randn(40, d).astype(
        np.float32)
    s = HostIvfSearcher(d, metric, qtype=qtype, nlist=64, nprobe=8,
                        train_sample=4000, query_block=16, **CPU).train(v)
    _, idx = s.search(q, topk=k, return_items=False)
    # golden over the dequantized corpus: this measures IVF probe recall
    vv = s.reconstruct(np.arange(n))
    qq = q / np.linalg.norm(q, axis=1, keepdims=True) if metric == "cos" \
        else q
    if metric == "l2":
        golden = np.argsort(((qq[:, None] - vv[None]) ** 2).sum(-1),
                            axis=1)[:, :k]
    else:
        golden = np.argsort(-(qq @ vv.T), axis=1)[:, :k]
    hits = sum(len(set(idx[r]) & set(golden[r])) for r in range(len(q)))
    assert hits / (len(q) * k) > 0.9, (metric, qtype, hits / (len(q) * k))


def test_host_ivf_transfers_only_probed_clusters():
    n, d = 16000, 16
    v = _clustered(n, d, n_cent=128)
    s = HostIvfSearcher(d, "ip", qtype="sq8", nlist=128, nprobe=4,
                        train_sample=8000, **CPU).train(v)
    q = v[:2]
    rows = s._union_rows(q)
    clusters = np.unique(s._probe(q))
    sizes = s._offsets[clusters + 1] - s._offsets[clusters]
    assert len(rows) == sizes.sum() < 0.15 * n
    assert len(np.unique(rows)) == len(rows)
    _, idx = s.search(q, topk=5, return_items=False)
    assert idx.shape == (2, 5)


def test_host_ivf_save_load_and_factory(tmp_path):
    v = _clustered(5000, 8, n_cent=16, seed=22)
    q = v[:6]
    s = index_factory(8, "HostIVF32,SQ8", metric="l2", nprobe=6,
                      train_sample=2500, **CPU)
    assert isinstance(s, HostIvfSearcher) and s.nlist == 32
    s.train(v)
    s1, i1 = s.search(q, topk=4, return_items=False)
    path = str(tmp_path / "hostivf.npz")
    s.save(path)
    r = HostIvfSearcher.load(path, **CPU)
    s2, i2 = r.search(q, topk=4, return_items=False)
    np.testing.assert_array_equal(s2, s1)
    np.testing.assert_array_equal(i2, i1)
    with pytest.raises(NotImplementedError):
        s.add(v[:10])


def test_host_ivf_reconstruct_maps_original_ids():
    v = _clustered(3000, 8, seed=23)
    s = HostIvfSearcher(8, "ip", qtype="f32", nlist=16, nprobe=4,
                        train_sample=1500, **CPU).train(v)
    assert not np.array_equal(s._order, np.arange(3000))
    np.testing.assert_array_equal(s.reconstruct(np.arange(50)), v[:50])


def test_reconstruct_and_recall_on_clustered():
    rng = np.random.RandomState(12)
    centers = rng.randn(32, 16).astype(np.float32)
    v = centers[rng.randint(0, 32, 4000)] + \
        0.1 * rng.randn(4000, 16).astype(np.float32)
    q = v[:50] + 0.05 * rng.randn(50, 16).astype(np.float32)
    host = StreamingSqSearcher(16, "ip", qtype="sq8", block_items=1024,
                               **CPU).train(v)
    _, idx = host.search(q, topk=20, return_items=False)
    golden = np.argsort(-(q @ v.T), axis=1)[:, :20]
    hits = sum(len(set(idx[r]) & set(golden[r])) for r in range(50))
    assert hits / (50 * 20) > 0.9
    assert np.abs(host.reconstruct(np.arange(10)) - v[:10]).max() < 0.05


def test_host_ivf_hier_union_tournament_is_exact(monkeypatch):
    """nprobe = nlist ships the whole corpus as one union, large enough for
    the tournament (m_pad >= 256 k): kernel 5 forms its group maxima and
    the f32 results equal brute force."""
    calls = _spy(monkeypatch)
    n, d, k = 8192, 16, 10
    v = _clustered(n, d, n_cent=64, seed=24)
    q = v[:32] + 0.02 * np.random.RandomState(25).randn(32, d).astype(
        np.float32)
    s = HostIvfSearcher(d, "ip", qtype="f32", nlist=32, nprobe=32,
                        train_sample=4000, query_block=8, **CPU).train(v)
    sc, idx = s.search(q, topk=k, return_items=False)
    assert calls and all(c == (torch.float32, 8192, 8192) for c in calls)
    golden = np.argsort(-(q @ v.T), axis=1)[:, :k]
    np.testing.assert_allclose(sc, np.take_along_axis(q @ v.T, golden, 1),
                               rtol=1e-4, atol=1e-4)
    for r in range(len(q)):
        assert set(idx[r]) == set(golden[r])


def test_host_ivf_hier_union_l2(monkeypatch):
    calls = _spy(monkeypatch)
    n, d, k = 8192, 16, 10
    v = _clustered(n, d, n_cent=64, seed=26)
    q = v[:16] + 0.02 * np.random.RandomState(27).randn(16, d).astype(
        np.float32)
    s = HostIvfSearcher(d, "l2", qtype="f32", nlist=32, nprobe=32,
                        train_sample=4000, query_block=16, **CPU).train(v)
    sc, _ = s.search(q, topk=k, return_items=False)
    assert calls
    d2 = ((q[:, None] - v[None]) ** 2).sum(-1)
    np.testing.assert_allclose(sc, np.sqrt(np.sort(d2, axis=1)[:, :k]),
                               rtol=1e-3, atol=1e-3)


def test_streaming_load_dispatches_host_ivf_file(tmp_path):
    v = _clustered(3000, 8, seed=30)
    q = v[:5]
    s = HostIvfSearcher(8, "ip", qtype="f32", nlist=16, nprobe=16,
                        train_sample=1500, **CPU).train(v)
    p = str(tmp_path / "ivf.npz")
    s.save(p)
    r = StreamingSqSearcher.load(p, **CPU)
    assert isinstance(r, HostIvfSearcher)
    np.testing.assert_array_equal(r.search(q, 4, return_items=False)[1],
                                  s.search(q, 4, return_items=False)[1])
    flat = StreamingSqSearcher(8, "ip", qtype="f32", **CPU).train(v)
    pf = str(tmp_path / "flat.npz")
    flat.save(pf)
    with pytest.raises(ValueError, match="not a HostIvfSearcher file"):
        HostIvfSearcher.load(pf, **CPU)


def test_l2_xsq_sidecar_roundtrip(tmp_path):
    v = _clustered(3000, 8, seed=31)
    q = v[:8]
    s = HostIvfSearcher(8, "l2", qtype="sq8", nlist=16, nprobe=16,
                        train_sample=1500, **CPU).train(v)
    p = str(tmp_path / "l2.npz")
    s.save(p)
    assert "xsq" in np.load(p, allow_pickle=True).files
    r = HostIvfSearcher.load(p, **CPU)
    assert torch.equal(r._xsq, s._xsq)
    s1, i1 = s.search(q, topk=5, return_items=False)
    s2, i2 = r.search(q, topk=5, return_items=False)
    np.testing.assert_array_equal(s2, s1)
    np.testing.assert_array_equal(i2, i1)


# ------------------------------------------------------ against JAX
def _jax_and_port(qtype, metric, v, block_items, **kw):
    j = JaxStreaming(v.shape[1], metric, qtype=qtype,
                     block_items=block_items, **kw).train(v)
    t = StreamingSqSearcher(v.shape[1], metric, qtype=qtype,
                            block_items=block_items, **kw, **CPU).train(v)
    return j, t


def _same_state(j, t):
    np.testing.assert_array_equal(_codes(t._codes), _codes(j._codes))
    if j.qtype == "sq8":
        np.testing.assert_array_equal(t._vmin, j._vmin)
        np.testing.assert_array_equal(t._scale, j._scale)
    if j.metric == "l2":
        np.testing.assert_array_equal(t._xsq.numpy(), j._xsq)


@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
@pytest.mark.parametrize("block_items", [1024, 4096], ids=["tiny", "hier"])
def test_f32_streaming_matches_jax(monkeypatch, metric, block_items):
    """5000 items in blocks of 1024 (full-score top-k a block) or 4096
    (the tournament, k 9 <= 16 supergroups), a partial tail block each."""
    calls = _spy(monkeypatch)
    v, q = _corpus(5000, 16, seed=40), _corpus(19, 16, seed=41)
    j, t = _jax_and_port("f32", metric, v, block_items)
    _same_state(j, t)
    (js, ji), (ts, ti) = (x.search(q, 9, return_items=False) for x in (j, t))
    assert bool(calls) == (block_items == 4096)
    _same_ids_up_to_ties(ts, ti, np.asarray(js), np.asarray(ji))
    assert (ti == np.asarray(ji)).mean() >= 0.99


@pytest.mark.parametrize("qtype", ["bf16", "sq8"])
@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
def test_quantized_tiny_blocks_match_jax(qtype, metric):
    """The tiny-block path scores f32 queries against the codes on both
    sides: equal state, equal top-k up to ties."""
    v, q = _corpus(3000, 16, seed=42), _corpus(15, 16, seed=43)
    j, t = _jax_and_port(qtype, metric, v, 512)
    _same_state(j, t)
    (js, ji), (ts, ti) = (x.search(q, 7, return_items=False) for x in (j, t))
    _same_ids_up_to_ties(ts, ti, np.asarray(js), np.asarray(ji))


@pytest.mark.parametrize("qtype", ["bf16", "sq8"])
@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
def test_quantized_hier_blocks_against_the_jax_cpu_path(monkeypatch, qtype,
                                                        metric):
    """The port's group maxima from bf16-rounded queries (kernel 5's uint8
    and bf16 forms), JAX's CPU path's from f32 ones: an id in one top-k
    and not the other scores, over the dequantized corpus, within 2^-8 ·
    Σ_d |qs_d · code_d| (twice that for l2) of the k-th best; scores of
    the ids both return agree within 1e-4."""
    calls = _spy(monkeypatch)
    k = 10
    v, q = _corpus(12000, 16, seed=44), _corpus(16, 16, seed=45)
    j, t = _jax_and_port(qtype, metric, v, 4096)
    _same_state(j, t)
    (js, ji), (ts, ti) = (x.search(q, k, return_items=False) for x in (j, t))
    js, ji = np.asarray(js), np.asarray(ji)
    assert {c[0] for c in calls} == {torch.uint8 if qtype == "sq8"
                                     else torch.bfloat16}
    xhat = t.reconstruct(np.arange(len(v))).astype(np.float64)
    qq = q / np.linalg.norm(q, axis=1, keepdims=True) if metric == "cos" else q
    qq = qq.astype(np.float64)
    score = -((qq[:, None, :] - xhat[None]) ** 2).sum(-1) if metric == "l2" \
        else qq @ xhat.T
    kth = np.sort(score, axis=1)[:, -k]
    codes = _codes(t._codes).astype(np.float64)
    scale = t._scale if qtype == "sq8" else np.ones(16)
    bound = 2.0 ** -8 * (np.abs(qq * scale) @ np.abs(codes).T).max(1) \
        * (2.0 if metric == "l2" else 1.0)
    differ = 0
    for r in range(len(q)):
        for i in set(ti[r]) ^ set(ji[r]):
            differ += 1
            assert score[r, i] >= kth[r] - bound[r] - 1e-6, (r, i)
    jpos = {(r, ji[r, c]): js[r, c] for r in range(len(q)) for c in range(k)}
    for r in range(len(q)):
        for c in range(k):
            if (r, ti[r, c]) in jpos:
                assert abs(ts[r, c] - jpos[(r, ti[r, c])]) <= ATOL
    assert differ <= 4                 # rare: near-ties at bf16 precision


@pytest.mark.parametrize("qtype", ["bf16", "sq8"])
def test_quantized_hier_blocks_match_the_jax_kernel_path(monkeypatch, qtype):
    """JAX's accelerator path on the CPU (the Pallas kernel in interpret
    mode, D 128, blocks a multiple of 128·G) rounds the queries to bf16 as
    the port does: equal top-k up to ties."""
    import jax
    import recommendflow_tpu.ops.pallas.grouped_topk as pg
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(pg, "grouped_score_max",
                        functools.partial(pallas, interpret=True))
    v, q = _corpus(6000, 128, seed=46), _corpus(8, 128, seed=47)
    j, t = _jax_and_port(qtype, "ip", v, 4096)
    (js, ji), (ts, ti) = (x.search(q, 10, return_items=False) for x in (j, t))
    _same_ids_up_to_ties(ts, ti, np.asarray(js), np.asarray(ji), tol=ATOL)


@pytest.mark.parametrize("qtype", ["bf16", "sq8", "f32"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_npz_crosses_both_ways(tmp_path, qtype, metric):
    """JAX save -> port load and port save -> JAX load: equal codes and
    equal search results (StreamingSqSearcher; bf16 codes travel as their
    uint16 bits)."""
    v, q = _corpus(2500, 16, seed=48), _corpus(9, 16, seed=49)
    j, t = _jax_and_port(qtype, metric, v, 1024)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j.save(pj)
    t.save(pt)
    tj = StreamingSqSearcher.load(pj, **CPU)
    jt = JaxStreaming.load(pt)
    _same_state(j, tj)
    _same_state(jt, t)
    if qtype == "bf16":
        assert np.load(pt)["codes"].dtype == np.uint16
    for a, b in ((tj, t), (jt, j)):
        (sa, ia), (sb, ib) = (x.search(q, 6, return_items=False)
                              for x in (a, b))
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))


def _jax_ivf(qtype, metric, v, tmp_path, **kw):
    """A JAX HostIvfSearcher and the port's loaded from its `.npz` (the
    same centroids, order, offsets and codes)."""
    j = JaxHostIvf(v.shape[1], metric, qtype=qtype, train_sample=4000,
                   **kw).train(v)
    p = str(tmp_path / "jivf.npz")
    j.save(p)
    return j, HostIvfSearcher.load(p, **CPU)


@pytest.mark.parametrize("qtype", ["f32", "bf16", "sq8"])
@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
@pytest.mark.parametrize("path", ["hier", "small"])
def test_host_ivf_union_matches_jax(monkeypatch, tmp_path, qtype, metric,
                                    path):
    """The union scorer on its two paths against JAX's from one state:
    'hier' ships every cluster (8192 rows, kernel 5 + the tournament),
    'small' probes 2 of 64 clusters for 2 queries (full scores, chunked
    top-k). f32 ids are equal up to ties; bf16 / sq8 on the hier path may
    differ by the rounding of the queries only where scores nearly tie, so
    their top-k overlap in all but a few ids and the shared ids' scores
    agree."""
    calls = _spy(monkeypatch)
    v = _clustered(8192, 16, n_cent=64, seed=50)
    rng = np.random.RandomState(51)
    if path == "hier":
        j, t = _jax_ivf(qtype, metric, v, tmp_path, nlist=32, nprobe=32,
                        query_block=8)
        q = v[:16] + 0.02 * rng.randn(16, 16).astype(np.float32)
    else:
        j, t = _jax_ivf(qtype, metric, v, tmp_path, nlist=64, nprobe=2,
                        query_block=2)
        q = v[:4] + 0.02 * rng.randn(4, 16).astype(np.float32)
    np.testing.assert_array_equal(t._order, np.asarray(j._order))
    (js, ji), (ts, ti) = (x.search(q, 10, return_items=False) for x in (j, t))
    js, ji = np.asarray(js), np.asarray(ji)
    assert bool(calls) == (path == "hier")
    if qtype == "f32" or path == "small":
        _same_ids_up_to_ties(ts, ti, js, ji, tol=ATOL)
        return
    jpos = {(r, ji[r, c]): js[r, c] for r in range(len(q)) for c in range(10)}
    shared = [(r, c) for r in range(len(q)) for c in range(10)
              if (r, ti[r, c]) in jpos]
    assert len(shared) >= 10 * len(q) - 4
    for r, c in shared:
        assert abs(ts[r, c] - jpos[(r, ti[r, c])]) <= ATOL


@pytest.mark.parametrize("qtype", ["bf16", "sq8"])
def test_host_ivf_npz_crosses_both_ways(tmp_path, qtype):
    """A JAX HostIvf file searched by the port equals JAX's search (the
    small-union path: the same f32 maths), and the port's own file, loaded
    by JAX, holds its layout and searches as the port does."""
    v = _clustered(6000, 16, n_cent=48, seed=52)
    q = v[:3] + 0.01
    j, t = _jax_ivf(qtype, "l2", v, tmp_path, nlist=48, nprobe=2,
                    query_block=3)
    (js, ji), (ts, ti) = (x.search(q, 8, return_items=False) for x in (j, t))
    _same_ids_up_to_ties(ts, ti, np.asarray(js), np.asarray(ji), tol=ATOL)
    own = HostIvfSearcher(16, "l2", qtype=qtype, nlist=48, nprobe=2,
                          train_sample=4000, query_block=3, **CPU).train(v)
    p = str(tmp_path / "own.npz")
    own.save(p)
    back = JaxHostIvf.load(p)
    np.testing.assert_array_equal(np.asarray(back._order), own._order)
    np.testing.assert_array_equal(np.asarray(back._offsets), own._offsets)
    np.testing.assert_array_equal(_codes(back._codes), _codes(own._codes))
    np.testing.assert_array_equal(back._xsq, own._xsq.numpy())
    (bs, bi), (os_, oi) = (x.search(q, 8, return_items=False)
                           for x in (back, own))
    _same_ids_up_to_ties(os_, oi, np.asarray(bs), np.asarray(bi), tol=ATOL)


def test_stream_pads_the_tail_on_the_device():
    """Each block handed out holds its rows, zero rows past the corpus and
    +inf norms there; the buffers alternate."""
    v = _corpus(1300, 8, seed=53)
    s = StreamingSqSearcher(8, "l2", qtype="f32", block_items=512,
                            **CPU).train(v)
    seen = []
    for start, valid, codes, xsq in s._stream():
        assert codes.shape == (512, 8) and xsq.shape == (512,)
        np.testing.assert_array_equal(codes[:valid].numpy(),
                                      v[start:start + valid])
        assert not codes[valid:].any() and torch.isinf(xsq[valid:]).all()
        seen.append((start, valid, codes.data_ptr()))
    assert [x[:2] for x in seen] == [(0, 512), (512, 512), (1024, 276)]
    assert seen[0][2] == seen[2][2] != seen[1][2]


def test_empty_union_and_small_corpus_edges():
    """A probe of empty clusters returns the worst score; a corpus smaller
    than k returns every item (JAX's pads)."""
    v = _clustered(600, 8, n_cent=4, seed=54)
    s = HostIvfSearcher(8, "l2", qtype="f32", nlist=16, nprobe=1,
                        train_sample=600, **CPU).train(v)
    # one more list, empty, whose centroid is the query's nearest
    s._centroids = torch.cat([s._centroids, torch.full((1, 8), 1e3)])
    s._offsets = np.append(s._offsets, s._offsets[-1])
    s.nlist += 1
    sc, idx = s.search(np.full((1, 8), 1e3, np.float32), 3,
                       return_items=False)
    assert np.isinf(sc).all() and (idx == 0).all()
    small = StreamingSqSearcher(8, "ip", qtype="f32", block_items=256,
                                **CPU).train(v[:5])
    sc, idx = small.search(v[:2], 10, return_items=False)
    assert idx.shape == (2, 5) and sorted(idx[0]) == list(range(5))


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (StreamingSqSearcher, HostIvfSearcher):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index_factory(8, "HostSQ8")
