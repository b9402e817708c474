"""examples/cascade_demo_torch.py, the matching -> (pre)ranking cascade on
the port, on the CPU.

  * `rerank` (the item-prior blend and re-order) against the JAX demo's own
    lines (examples/cascade_demo.py, read from its source and run on the
    same candidates, scores and ranker scores): the same order, bit for
    bit, and the same hit metrics;
  * the demo at demo size into a temporary directory: stage-1 candidates
    an exact top-k of the demo's own vectors (ids aside only where scores
    tie within 1e-5), hit@K in [0, 1], and the re-ranked hit@50 equal to
    stage-1's (a re-order within one candidate set of k = 50 cannot change
    hit@50; a fault in the re-order's join would);
  * Cold on demo_recall, whose field stack takes the dim-16 slots and
    leaves the dim-8 group out: three carried split steps against the JAX
    trainer (the unused group's gathered rows get a zero gradient, as
    JAX's cotangent, and keep their bits).
The stages' numbers cannot match the JAX demo's: initialisation and dropout
draw from other generators.
"""
import importlib.util
import os
import textwrap

import ml_dtypes
import numpy as np
import pytest

import _torch_parity as tp
from recommendflow_tpu_torch import interop

JAX_DEMO = os.path.join(tp.ROOT, "examples", "cascade_demo.py")


def _demo():
    spec = importlib.util.spec_from_file_location(
        "cascade_demo_torch",
        os.path.join(tp.ROOT, "examples", "cascade_demo_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_rerank(cand_items, cand_scores, ranker_score, inverse, corpus):
    """The JAX demo's blend and re-order: its own source lines, from
    `item_prior = ...` to `reord = ...`, run on the given arrays."""
    lines = open(JAX_DEMO).read().splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.strip().startswith("item_prior = np.zeros("))
    end = next(i for i, ln in enumerate(lines)
               if ln.strip().startswith("reord = np.take_along_axis("))
    scope = {"np": np, "cand_items": cand_items, "cand_scores": cand_scores,
             "ranker_score": ranker_score, "inverse": inverse,
             "corpus": corpus}
    exec(textwrap.dedent("\n".join(lines[start:end + 1])), scope)
    return scope["reord"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rerank_is_the_jax_demos_arithmetic(seed):
    from recommendflow_tpu.retrieval import click_ranks as jranks
    from recommendflow_tpu.retrieval import recall_metrics as jmetrics
    from recommendflow_tpu_torch.retrieval import click_ranks, recall_metrics
    rng = np.random.RandomState(seed)
    n_items, n_rows, k = 300, 1000, 50
    corpus = rng.randn(n_items, 8).astype(np.float32)
    inverse = rng.randint(0, n_items, n_rows)
    cand_items = np.stack([rng.permutation(n_items)[:k]
                           for _ in range(n_rows)])
    cand_scores = -np.sort(-rng.rand(n_rows, k).astype(np.float32), axis=1)
    if seed == 2:                       # ties in the blend
        cand_scores = np.round(cand_scores, 1)
    ranker_score = rng.rand(n_rows).astype(np.float32)
    want = _jax_rerank(cand_items, cand_scores, ranker_score, inverse, corpus)
    got = _demo().rerank(cand_items, cand_scores, ranker_score, inverse,
                         len(corpus))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, cand_items)
    assert recall_metrics(click_ranks(got, inverse), [5, k]) == \
        jmetrics(jranks(want, inverse), [5, k])


def test_the_demo_runs_on_the_cpu(tmp_path, capsys):
    demo = _demo()
    res = demo.main(device="cpu", data_dir=str(tmp_path / "data"))
    assert "Cascade demo" in capsys.readouterr().out
    k, q, corpus = res["k"], res["queries"], res["corpus"]
    assert k == 50 and len(corpus) > k and len(q) == len(res["inverse"])
    # stage 1: an exact top-k of the demo's own vectors (cos)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    exact = qn.astype(np.float64) @ cn.astype(np.float64).T
    ref = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    kth = np.take_along_axis(exact, ref[:, -1:], axis=1)[:, 0]
    got = res["cand_items"]
    np.testing.assert_allclose(
        res["cand_scores"], np.take_along_axis(exact, got, axis=1),
        rtol=0, atol=1e-5)
    for r in range(len(got)):
        for i in set(got[r].tolist()) ^ set(ref[r].tolist()):
            assert abs(exact[r, i] - kth[r]) <= 1e-5, (r, i)
    s1, s2 = res["stage1"], res["stage2"]
    for m in (s1, s2):
        assert 0.0 <= m[f"hit@{k}"] <= 1.0 and 0.0 <= m["hit@5"] <= 1.0
    assert s2[f"hit@{k}"] == s1[f"hit@{k}"]
    # the re-order keeps each row's candidates and is rerank's
    np.testing.assert_array_equal(np.sort(res["reordered"], axis=1),
                                  np.sort(got, axis=1))
    np.testing.assert_array_equal(res["reordered"], demo.rerank(
        got, res["cand_scores"], res["ranker_score"], res["inverse"],
        len(corpus)))
    assert all(np.isfinite(h["loss"]) for h in res["recall_history"]
               + res["rank_history"])
    assert set(res["seconds"]) == {"recall_fit", "recall_predict", "corpus",
                                   "search", "rank_fit", "rank_predict",
                                   "rerank"}


@pytest.mark.parametrize("strategy", ["sparse_set", "dense"])
def test_cold_on_demo_recall_split_steps_match_jax(strategy):
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    from recommendflow_tpu_torch.train.trainer import Trainer
    path = "recommendflow_tpu.models.preranking.cold.Cold"
    kw = {"hidden_units": (32,), "dropout": 0.0}
    jc, tc = tp.conf_pair(networks={"table_dtype": "float32"})
    batches = [synthetic_batch(compile_schema(jc.features), 64, seed=70 + i)
               for i in range(4)]
    jm, _ = jbuild(path, {"conf": jc, **kw})
    jt = JTrainer(jm, learning_rate=1e-3, table_update="split", seed=0)
    js = jt.init_state(jt._put(batches[0]))
    jt._split_dims = {d: strategy for d in jt._split_dims}
    js, _ = jt.train_step(js, batches[0])
    tm, _ = tbuild(path, {"conf": tc, "device": "cpu", **kw})
    tt = Trainer(tm, learning_rate=1e-3, table_update="split",
                 split_strategy=strategy, device="cpu")
    ts = tt.init_state(batches[0])
    assert tt._split_dims == {8: strategy, 16: strategy}
    interop.load_train_state(ts, tp.jax_state_tree(js))
    dim8 = tm.embedder.table_dim8.detach().clone()
    jl, tl = [], []
    for b in batches[1:]:
        js, m = jt.train_step(js, b)
        jl.append(float(m["loss"]))
        ts, m = tt.train_step(ts, b)
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tm.embedder.table_dim8.detach().equal(dim8)
    jfin = tp.flat_tree(tp.jax_state_tree(js))
    tfin = tp.flat_tree(interop.train_state_tree(ts, ml_dtypes.bfloat16))
    assert sorted(jfin) == sorted(tfin)
    for k, a in jfin.items():
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(tfin[k], a, rtol=0, atol=1e-5,
                                       err_msg=k)
        else:
            assert tfin[k] == a, k
