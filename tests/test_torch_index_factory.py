"""index_factory, EncoderSearcher and the group-wise recall evaluation
against the JAX package's on the CPU.

* Every index string resolves to the port's counterpart of the class the
  JAX factory builds, with the same parameters, the host-tier strings
  among them; `mesh=` with something that is not a port Mesh raises
  TypeError (ValueError on a host-tier string, as in JAX;
  tests/test_torch_sharded_search.py drives the sharded searchers).
* EncoderSearcher in DataFrame mode, with the port's TextEncoderService and
  the JAX one sharing weights through `interop` (the service parity of
  tests/test_torch_encoder_service.py): the same joined frame, sims within
  1e-5. Array mode, list topK, cal_sim for every metric (within 1e-5 of the
  JAX cal_sim, same order), save_searcher / load_searcher.
* batch_compute_group_recall_score equals the JAX one.
"""
import jax
import numpy as np
import pytest

import _torch_parity as tp  # noqa: F401  (pins torch threads)
from recommendflow_tpu.encoder import TextEncoderService as JaxService
from recommendflow_tpu.encoder import Tokenizer as JaxTokenizer
from recommendflow_tpu.encoder.tokenizer import build_demo_vocab
from recommendflow_tpu.retrieval import EncoderSearcher as JaxEncoderSearcher
from recommendflow_tpu.retrieval import index_factory as jax_factory
from recommendflow_tpu_torch.encoder import TextEncoderService, Tokenizer
from recommendflow_tpu_torch.retrieval import EncoderSearcher, index_factory
from recommendflow_tpu_torch.retrieval import searcher as ts

pd = pytest.importorskip("pandas")

SPECS = [("Flat", {}), ("IVF64", {}), ("IVF256,Flat", {"nprobe": 3}),
         ("PQ8", {}), ("PQ16x8", {"item_block": 1024}),
         ("IVF32,PQ8", {}), ("IVF16,PQ16x8", {"nprobe": 2}), ("SQ8", {}),
         ("SQfp16", {}), ("SQbf16", {"item_block": 512}), ("sq8", {}),
         ("ivf8,pq4", {})]


@pytest.mark.parametrize("spec,kw", SPECS)
def test_strings_resolve_as_in_jax(spec, kw):
    j = jax_factory(32, spec, "ip", **kw)
    t = index_factory(32, spec, "ip", device="cpu", **kw)
    names = {"TpuSearcher": "FlatSearcher"}
    assert type(t).__name__ == names.get(type(j).__name__, type(j).__name__)
    assert str(t.device) == "cpu" and t.metric == j.metric == "ip"
    for attr in ("nlist", "nprobe", "num_subspaces", "qtype", "item_block",
                 "query_block"):
        assert getattr(t, attr, None) == getattr(j, attr, None), attr


def test_unported_strings_and_mesh_raise():
    """The host-tier strings (once refused) build the JAX factory's classes
    with its attributes, and raise its ValueError with mesh=; mesh= on the
    other strings and unsupported strings still raise."""
    for spec in ("HostSQ8", "HostFlat", "HostSQfp16", "hostsqbf16",
                 "HostIVF1024", "HostIVF64,SQbf16", "HostIVF32,Flat",
                 "HostIVF16,SQ8"):
        j = jax_factory(16, spec, "l2")
        t = index_factory(16, spec, "l2", device="cpu")
        assert type(t).__name__ == type(j).__name__, spec
        for attr in ("dim", "metric", "qtype", "block_items", "query_block",
                     "nlist", "nprobe", "train_sample", "kmeans_iters",
                     "seed"):
            assert getattr(t, attr, None) == getattr(j, attr, None), attr
        with pytest.raises(ValueError, match="host tier streams"):
            index_factory(16, spec, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        index_factory(16, "Flat", mesh=object())
    with pytest.raises(ValueError, match="unsupported"):
        index_factory(16, "HNSW32", device="cpu")
    with pytest.raises(ValueError, match="not in"):
        index_factory(16, "PQ2", "canberra", device="cpu")
    assert index_factory(16, "Flat", "l_inf", device="cpu").metric == "l_inf"
    assert ts.index_factory is index_factory


WORDS = ["hello", "world", "deep", "rank", "search", "click", "phone",
         "music", "video", "news", "store"]
SIZES = dict(max_len=16, batch_size=8, model_dim=32, num_layers=2,
             num_heads=4, ffn_hidden=64)


@pytest.fixture(scope="module")
def services():
    vocab = build_demo_vocab(WORDS)
    jax_svc = JaxService(JaxTokenizer(vocab), **SIZES)
    variables = jax.tree.map(np.asarray, jax_svc.variables)
    port = TextEncoderService(Tokenizer(vocab), variables=variables,
                              device="cpu", **SIZES)
    return jax_svc, port


def _items():
    rng = np.random.RandomState(0)
    titles = list(dict.fromkeys(
        " ".join(rng.choice(WORDS, size=rng.randint(1, 6))) for _ in range(80)))
    return pd.DataFrame({"title": titles, "cat": np.arange(len(titles)) % 5,
                         "price": np.arange(len(titles), dtype=float)})


@pytest.mark.parametrize("index_param", ["Flat", "SQ8"])
def test_dataframe_mode_matches_jax(services, index_param):
    jax_svc, port = services
    items = _items()
    j = JaxEncoderSearcher(encoder=jax_svc, items=items,
                           index_param=index_param, measurement="cos").train()
    t = EncoderSearcher(encoder=port, items=items, index_param=index_param,
                        measurement="cos", device="cpu").train()
    targets = list(items.title[:6]) + ["music news"]
    a = t.search(targets, topK=5, keep_rank_no=True)
    b = j.search(targets, topK=5, keep_rank_no=True)
    assert list(a.columns) == list(b.columns) == [
        "source_item", "sim_item", "sim_val", "rank_no", "cat", "price"]
    np.testing.assert_allclose(a.sim_val, b.sim_val, rtol=0, atol=1e-5)
    same = a.sim_item.values == b.sim_item.values
    # a differing row may only be a tie of two items' similarities
    assert (np.abs(a.sim_val.values - b.sim_val.values)[~same] <= 1e-5).all()
    pd.testing.assert_frame_equal(a[same].reset_index(drop=True),
                                  b[same].reset_index(drop=True),
                                  check_exact=False, atol=1e-5)
    top = a[a.rank_no == 0]
    assert list(top.source_item[:6]) == list(top.sim_item[:6])
    per_k = t.search(targets[:2], topK=[1, 3])
    assert set(per_k) == {1, 3} and len(per_k[3]) == 6
    assert "rank_no" not in per_k[3].columns
    one = t.search(targets[0], topK=2)
    assert len(one) == 2 and (one.source_item == targets[0]).all()


class _HashEncoder:
    """One deterministic text -> vector map for both packages (positive
    entries, as jensen_shannon needs), so cal_sim differs only by its own
    arithmetic."""

    def encode(self, texts):
        return np.stack([np.random.RandomState(
            sum(map(ord, t)) % 2 ** 31).rand(12).astype(np.float32) + 0.01
            for t in texts])


@pytest.mark.parametrize("metric", ["ip", "cos", "l2", "l1", "l_inf", "l_p",
                                    "brayCurtis", "canberra",
                                    "jensen_shannon"])
def test_cal_sim_matches_jax(metric):
    items = _items()
    kw = {"metric_arg": 2.5} if metric == "l_p" else {}
    j = JaxEncoderSearcher(encoder=_HashEncoder(), items=items,
                           measurement=metric, **kw)
    t = EncoderSearcher(encoder=_HashEncoder(), items=items,
                        measurement=metric, device="cpu", **kw)
    others = list(items.title[:12])
    a, b = t.cal_sim(others[3], others), j.cal_sim(others[3], others)
    np.testing.assert_allclose(a.score.values, b.score.values, rtol=0,
                               atol=1e-5)
    assert list(a["item"]) == list(b["item"])
    if metric != "ip":
        assert list(a["item"])[0] == others[3]        # itself first


def test_array_mode_and_pickle(tmp_path):
    rng = np.random.RandomState(1)
    vecs = rng.randn(300, 8).astype(np.float32)
    labels = [f"id{i}" for i in range(300)]
    j = JaxEncoderSearcher(items=vecs, item_list=labels,
                           index_param="SQ8").train()
    t = EncoderSearcher(items=vecs, item_list=labels, index_param="SQ8",
                        device="cpu").train()
    (ji, js, jx), (ti, ts_, tx) = (j.search(vecs[:5], topK=4, keep_rank_no=True),
                                   t.search(vecs[:5], topK=4, keep_rank_no=True))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts_, js, rtol=0, atol=1e-5)
    assert ti[1, 0] == "id1"
    res = t.search(vecs[:3], topK=[1, 2])
    assert res[1][0].shape == (3, 1) and len(res[2]) == 2
    p = str(tmp_path / "s.pkl")
    t.save_searcher(p)
    back = EncoderSearcher.load_searcher(p)
    np.testing.assert_array_equal(back.search(vecs[:5], topK=4)[0], ti)
    with pytest.raises(TypeError, match="ndarray"):
        EncoderSearcher(items=_items(), device="cpu")
    with pytest.raises(AttributeError, match="encode"):
        EncoderSearcher(encoder=object(), items=_items())
    with pytest.raises(RuntimeError, match="not trained"):
        EncoderSearcher(items=vecs).search(vecs[:1])


def test_unpicklable_encoder_is_dropped_with_a_warning(services, tmp_path):
    _, port = services

    class Local:                     # a local class does not pickle
        def encode(self, texts):
            return port.encode(texts)

    t = EncoderSearcher(encoder=Local(), items=_items(), device="cpu").train()
    with pytest.warns(UserWarning, match="not picklable"):
        t.save_searcher(str(tmp_path / "s.pkl"))
    back = EncoderSearcher.load_searcher(str(tmp_path / "s.pkl"))
    assert back.encoder is None and t.encoder is not None
    ids, _ = back.index.search(port.encode(["hello"]), 1, return_items=False)
    assert ids.shape == (1, 1)


def test_group_recall_matches_jax():
    from recommendflow_tpu.retrieval import eval as jev
    from recommendflow_tpu.retrieval.flat import TpuSearcher
    from recommendflow_tpu_torch.retrieval import eval as tev
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    rng = np.random.RandomState(5)
    items = rng.randn(400, 16).astype(np.float32)
    labels = rng.randint(0, 400, 2000)
    q = rng.randn(2000, 16).astype(np.float32) + 2.0 * items[labels]
    groups = rng.choice(["a", "b", "c"], 2000)
    w = rng.rand(2000)
    for weights in (None, w):
        jo, jg = jev.batch_compute_group_recall_score(
            TpuSearcher(16, "cos").train(items), q, labels, groups,
            [5, 10, 50], weights=weights, batch_size=700)
        to, tg = tev.batch_compute_group_recall_score(
            FlatSearcher(16, "cos", device="cpu").train(items), q, labels,
            groups, [5, 10, 50], weights=weights, batch_size=700)
        assert to == jo and tg == jg
        assert set(tg) == {"a", "b", "c"} and sum(
            g["count"] for g in tg.values()) == 2000
