"""SqSearcher against the JAX package's SqSearcher on the CPU, sq8 and bf16
codes, ip / cos / l2, on both search paths: the grouped tournament (forced
on a small corpus by lowering `_HIER_MIN_ITEMS` in both packages, as
tests/test_retrieval.py does) and the item-block scan.

* Codes, vmin and scale are equal (the same f32 operations on both sides).
* Top-k scores agree within 1e-4 and the ids of each row are equal as sets
  (the rule of tests/test_retrieval.py::test_sq_grouped_tournament_matches_
  flat_scan) on the item-block path, and on the tournament path against the
  JAX searcher's kernel path (the Pallas kernel in interpret mode). The port
  forms the group maxima as the kernel does, from bf16-rounded queries,
  where the JAX CPU path uses f32 queries: against that path an id may
  differ only where its score lies within the bf16 rounding bound of the
  k-th best.
* The port's group maxima equal the Pallas kernel's in interpret mode on
  the searcher's own operands (atol 1e-4: f32 sums in another order).
* add() with the frozen quantizer, reconstruct(), the `.npz` files both
  ways and pickling.
"""
import functools
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)
import recommendflow_tpu.retrieval._kernels as jk
from recommendflow_tpu.ops.pallas.grouped_topk import grouped_score_max as pallas
from recommendflow_tpu.retrieval.sq import SqSearcher as JaxSq
from recommendflow_tpu_torch.retrieval import _kernels as tk
from recommendflow_tpu_torch.retrieval import sq as tsq
from recommendflow_tpu_torch.retrieval.sq import SqSearcher

ATOL = 1e-4


def _data(n, d, q, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), rng.randn(q, d).astype(np.float32)


def _hier(monkeypatch):
    monkeypatch.setattr(jk, "_HIER_MIN_ITEMS", 1024)
    monkeypatch.setattr(tk, "_HIER_MIN_ITEMS", 1024)


def _same_results(a, b, atol=ATOL):
    (sa, ia), (sb, ib) = a, b
    assert sa.shape == sb.shape and ia.shape == ib.shape
    np.testing.assert_allclose(np.sort(sa, axis=1), np.sort(sb, axis=1),
                               rtol=0, atol=atol)
    for r in range(len(ia)):
        assert set(ia[r]) == set(ib[r]), f"row {r}"


def _pair(qtype, metric, vecs, **kw):
    j = JaxSq(vecs.shape[1], metric, qtype=qtype, item_block=1024, **kw).train(vecs)
    t = SqSearcher(vecs.shape[1], metric, qtype=qtype, item_block=1024,
                   device="cpu", **kw).train(vecs)
    return j, t


def _spy(monkeypatch):
    """Record the corpus dtype of each grouped_score_max call of the port's
    SqSearcher."""
    calls = []
    real = tsq.grouped_score_max
    monkeypatch.setattr(tsq, "grouped_score_max",
                        lambda *a, **k: calls.append(a[1].dtype) or real(*a, **k))
    return calls


def _same_state(j, t, qtype):
    assert tuple(t._codes.shape) == tuple(j._codes.shape)
    if qtype == "sq8":
        np.testing.assert_array_equal(t._codes.numpy(), np.asarray(j._codes))
        np.testing.assert_array_equal(t._vmin.numpy(), np.asarray(j._vmin))
        np.testing.assert_array_equal(t._scale.numpy(), np.asarray(j._scale))
    else:
        np.testing.assert_array_equal(t._codes.float().numpy(),
                                      np.asarray(j._codes).astype(np.float32))


def _jax_kernel_path(monkeypatch):
    """The JAX SqSearcher's accelerator path on the CPU: its use_kernel
    test sees a non-CPU backend and the Pallas kernel runs in interpret
    mode, as the JAX package's own kernel tests run it."""
    import jax
    import recommendflow_tpu.ops.pallas.grouped_topk as pg
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(pg, "grouped_score_max",
                        functools.partial(pallas, interpret=True))


@pytest.mark.parametrize("qtype", ["sq8", "bf16"])
@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
def test_item_block_path_matches_jax(monkeypatch, qtype, metric):
    vecs, q = _data(20000, 16, 16, seed=5)
    calls = _spy(monkeypatch)
    j, t = _pair(qtype, metric, vecs)
    _same_state(j, t, qtype)
    _same_results(j.search(q, topk=10, return_items=False),
                  t.search(q, topk=10, return_items=False))
    assert calls == [] and j._codes_g is None


@pytest.mark.parametrize("qtype", ["sq8", "bf16"])
@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
def test_tournament_path_matches_the_jax_kernel_path(monkeypatch, qtype,
                                                     metric):
    """Both sides form the group maxima from bf16-rounded queries (the
    Pallas kernel in interpret mode; the port's kernel contract through
    its plain version) and rescore in f32: equal top-k."""
    _hier(monkeypatch)
    _jax_kernel_path(monkeypatch)
    vecs, q = _data(20000, 128, 12, seed=5)
    calls = _spy(monkeypatch)
    j, t = _pair(qtype, metric, vecs)
    _same_state(j, t, qtype)
    _same_results(j.search(q, topk=10, return_items=False),
                  t.search(q, topk=10, return_items=False))
    assert calls == [torch.uint8 if qtype == "sq8" else torch.bfloat16]
    assert j._codes_g is not None


@pytest.mark.parametrize("qtype", ["sq8", "bf16"])
@pytest.mark.parametrize("metric", ["ip", "cos", "l2"])
def test_tournament_path_against_the_jax_cpu_path(monkeypatch, qtype, metric):
    """The JAX CPU path forms the group maxima from f32 queries, the port
    (as the kernel) from bf16-rounded ones. Every id that is in one top-k
    and not the other scores, over the dequantized corpus, within the
    rounding bound of the k-th best: 2^-8 · Σ_d |qs_d · code_d| (|q_d| for
    l2, whose surrogate doubles the dot product), the most a bf16 rounding
    of the queries moves a group's max. The scores both return agree
    within 1e-4."""
    _hier(monkeypatch)
    vecs, q = _data(20000, 16, 16, seed=5)
    calls = _spy(monkeypatch)
    j, t = _pair(qtype, metric, vecs)
    _same_state(j, t, qtype)
    (js, ji), (ts, ti) = (j.search(q, topk=10, return_items=False),
                          t.search(q, topk=10, return_items=False))
    assert calls and j._codes_g is not None
    xhat = t.reconstruct(np.arange(20000)).astype(np.float64)
    qq = q / np.linalg.norm(q, axis=1, keepdims=True) if metric == "cos" else q
    qq = qq.astype(np.float64)
    if metric == "l2":
        score = -((qq[:, None, :] - xhat[None]) ** 2).sum(-1)
    else:
        score = qq @ xhat.T
    kth = np.sort(score, axis=1)[:, -10]
    codes = t._codes[:20000].float().numpy().astype(np.float64)
    scale = t._scale.numpy() if qtype == "sq8" else np.ones(16)
    bound = 2.0 ** -8 * (np.abs(qq * scale) @ np.abs(codes).T).max(1) \
        * (2.0 if metric == "l2" else 1.0)
    differ = 0
    for r in range(len(q)):
        for i in set(ti[r]) ^ set(ji[r]):
            differ += 1
            assert score[r, i] >= kth[r] - bound[r] - 1e-6, (r, i)
    both = [(r, c) for r in range(len(q)) for c in range(10)
            if ti[r, c] in set(ji[r])]
    jpos = {(r, ji[r, c]): js[r, c] for r in range(len(q)) for c in range(10)}
    for r, c in both:
        assert abs(ts[r, c] - jpos[(r, ti[r, c])]) <= ATOL
    assert differ <= 4                 # rare: near-ties at bf16 precision


@pytest.mark.parametrize("qtype", ["sq8", "bf16"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_group_maxima_match_the_pallas_kernel(monkeypatch, qtype, metric):
    """The m1 the port's tournament reads, against the Pallas kernel in
    interpret mode on the same operands (D 128 and N_pad a multiple of
    128·G, the Pallas shape rules)."""
    _hier(monkeypatch)
    vecs, q = _data(20000, 128, 8, seed=6)
    seen = {}
    real = tsq.grouped_score_max

    def spy(qs, codes, sqn, **kw):
        seen.update(qs=qs, codes=codes, sqn=sqn, kw=kw)
        seen["m1"] = real(qs, codes, sqn, **kw)
        return seen["m1"]

    monkeypatch.setattr(tsq, "grouped_score_max", spy)
    t = SqSearcher(128, metric, qtype=qtype, item_block=2048,
                   device="cpu").train(vecs)
    t.search(q, topk=10)
    codes = seen["codes"].numpy() if qtype == "sq8" else \
        jnp.asarray(seen["codes"].float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(pallas(
        jnp.asarray(seen["qs"].numpy()), jnp.asarray(codes),
        None if seen["sqn"] is None else jnp.asarray(seen["sqn"].numpy()),
        interpret=True, **seen["kw"])).T
    np.testing.assert_allclose(seen["m1"].numpy(), ref, rtol=0, atol=ATOL)


def test_add_frozen_quantizer_and_reconstruct():
    rng = np.random.RandomState(6)
    a = rng.randn(800, 8).astype(np.float32)
    j = JaxSq(8, "l2", qtype="sq8", item_block=256).train(a)
    t = SqSearcher(8, "l2", qtype="sq8", item_block=256, device="cpu").train(a)
    b = np.concatenate([rng.randn(200, 8).astype(np.float32),
                        np.full((1, 8), 100.0, np.float32)])     # clips
    j.add(b, items=np.arange(200, 401))
    t.add(b, items=np.arange(200, 401))
    assert t.num_items == j.num_items == 1001
    np.testing.assert_array_equal(t.items, j.items)
    np.testing.assert_array_equal(t._codes.numpy(), np.asarray(j._codes))
    np.testing.assert_array_equal(t._vmin.numpy(), np.asarray(j._vmin))
    idx = [0, 5, 900, 1000]
    np.testing.assert_array_equal(t.reconstruct(idx), j.reconstruct(idx))
    np.testing.assert_array_equal(t.reconstruct(3), j.reconstruct(3))
    _same_results(j.search(b[:6], topk=5, return_items=False),
                  t.search(b[:6], topk=5, return_items=False))
    with pytest.raises(ValueError):
        t.add(a[0])
    bf = SqSearcher(8, "ip", qtype="bf16", item_block=256, device="cpu").train(a)
    jb = JaxSq(8, "ip", qtype="bf16", item_block=256).train(a)
    bf.add(b[:50])
    jb.add(b[:50])
    np.testing.assert_array_equal(bf.reconstruct(np.arange(850)),
                                  jb.reconstruct(np.arange(850)))


@pytest.mark.parametrize("qtype,metric", [("sq8", "l2"), ("bf16", "cos"),
                                          ("sq8", "ip")])
def test_npz_crosses_both_ways(tmp_path, qtype, metric):
    vecs, q = _data(3000, 24, 12, seed=7)
    items = np.array([f"i{i}" for i in range(3000)])
    j = JaxSq(24, metric, qtype=qtype, item_block=512,
              query_block=256).train(vecs, items=items)
    t = SqSearcher(24, metric, qtype=qtype, item_block=512, query_block=256,
                   device="cpu").train(vecs, items=items)
    j.save(str(tmp_path / "j.npz"))
    t.save(str(tmp_path / "t"))
    jkeys = set(np.load(str(tmp_path / "j.npz")).files)
    assert set(np.load(str(tmp_path / "t.npz")).files) == jkeys
    from_j = SqSearcher.load(str(tmp_path / "j.npz"), device="cpu")
    from_t = JaxSq.load(str(tmp_path / "t.npz"))
    assert (from_j.qtype, from_j.item_block, from_j.query_block) == \
        (qtype, 512, 256)
    for a, b in ((j, from_j), (t, from_t)):
        ia, sa, xa = a.search(q, topk=7)
        ib, sb, xb = b.search(q, topk=7)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(sa, sb, rtol=0, atol=ATOL)


def test_pickle_round_trip_and_device_by_name(monkeypatch):
    _hier(monkeypatch)
    vecs, q = _data(20000, 16, 8, seed=8)
    t = SqSearcher(16, "l2", qtype="sq8", item_block=1024,
                   device="cpu").train(vecs)
    before = t.search(q, topk=10, return_items=False)
    state = t.__getstate__()
    assert state["device"] == "cpu" and isinstance(state["_codes"], np.ndarray)
    again = pickle.loads(pickle.dumps(t))
    after = again.search(q, topk=10, return_items=False)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[0], before[0])
    state["device"] = "cuda:7"            # a device this machine lacks
    with pytest.raises(RuntimeError, match="cuda:7"):
        SqSearcher.__new__(SqSearcher).__setstate__(state)
    with pytest.raises(ValueError, match="qtype"):
        SqSearcher(16, "ip", qtype="sq4", device="cpu")
    with pytest.raises(ValueError, match="not in"):
        SqSearcher(16, "l1", device="cpu")
