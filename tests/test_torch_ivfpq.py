"""IvfPqSearcher against the JAX package's on the CPU: an index built and
saved by the JAX package loads into the port and searches alike (scores
within 1e-3, room for the bf16 lookup tables; both sides round the same
tables, so they agree far closer), add() encodes with the carried
quantizers, a `.npz` written by the port loads into the JAX package, and the
port's own build scans every list at full probe (the clustered world of
tests/test_torch_ivf_pq.py).
"""
import pickle

import numpy as np
import pytest

import _torch_parity as tp
from recommendflow_tpu.retrieval.pq import IvfPqSearcher as JaxIvfPq
from recommendflow_tpu_torch.retrieval.pq import IvfPqSearcher, PqSearcher


@pytest.fixture(scope="module")
def world():
    return tp.clustered_world()


_agree = tp.agree


@pytest.mark.parametrize("metric", ["cos", "ip", "l2"])
def test_ivfpq_from_jax_npz_matches_jax(world, tmp_path, metric):
    corpus, q = world
    j = JaxIvfPq(32, metric, nlist=16, nprobe=4, num_subspaces=8,
                 cap_factor=1.2, kmeans_iters=5, query_block=16).train(corpus)
    j.save(str(tmp_path / "j.npz"))
    t = IvfPqSearcher.load(str(tmp_path / "j.npz"), device="cpu")
    np.testing.assert_array_equal(t._lists.numpy(), np.asarray(j._lists))
    assert len(t._overflow_idx) > 0
    np.testing.assert_allclose(t.reconstruct([0, 9, 3999]),
                               j.reconstruct([0, 9, 3999]), rtol=0, atol=1e-6)
    _agree(j.search(q, topk=10, return_items=False),
           t.search(q, topk=10, return_items=False), 1e-3)
    # add() encodes with the carried quantizers on both sides
    j.add(corpus[:100] * 0.9)
    t.add(corpus[:100] * 0.9)
    np.testing.assert_array_equal(t._assign, j._assign)
    np.testing.assert_array_equal(t._codes.numpy(), np.asarray(j._codes))
    _agree(j.search(q, topk=10, return_items=False),
           t.search(q, topk=10, return_items=False), 1e-3)
    t.save(str(tmp_path / "t.npz"))
    back = JaxIvfPq.load(str(tmp_path / "t.npz"))
    _agree(j.search(q, topk=10, return_items=False),
           back.search(q, topk=10, return_items=False), 1e-6)


def test_ivfpq_own_build_full_probe_and_pickle(world):
    corpus, q = world
    t = IvfPqSearcher(32, "cos", nlist=16, nprobe=16, num_subspaces=8,
                      cap_factor=1.5, device="cpu").train(corpus)
    cb = t._codebooks.numpy().astype(np.float64)
    pq = PqSearcher(32, "cos", num_subspaces=8, device="cpu").train(corpus)
    _, _, idx = t.search(q, topk=10)
    recon = t.reconstruct(np.arange(4000))
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    bf = np.argsort(-(qn @ recon.T), axis=1)[:, :10]
    agree = np.mean([len(set(bf[i]) & set(idx[i])) / 10 for i in range(len(q))])
    assert agree >= 0.85, agree
    vn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    assert np.linalg.norm(recon - vn) < np.linalg.norm(
        pq.reconstruct(np.arange(4000)) - vn)
    assert cb.shape == (8, 256, 4)
    again = pickle.loads(pickle.dumps(t))
    for x, y in zip(again.search(q, topk=5), t.search(q, topk=5)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        t.add(corpus[0])
