"""IvfSearcher and PqSearcher against the JAX package's on the CPU, with the index state carried across: an index built by the JAX
package and saved loads into the port (and the reverse), and both search
alike. k-means draws its seeds from `torch.Generator` in the port and from
`jax.random` in JAX, so the port's own builds are held to their properties
(every cluster assigned, full probe exact) instead.

Tolerances: IVF scores within 1e-5 (f32 dot products summed in another
order); PQ within 1e-3, room for the bf16 codebook decode (both sides round
the same codebooks to bf16, so the scores agree far closer); ids equal
except among scores within the tolerance.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu.retrieval import _kernels as jk
from recommendflow_tpu.retrieval.flat import TpuSearcher
from recommendflow_tpu.retrieval.ivf import IvfSearcher as JaxIvf
from recommendflow_tpu.retrieval.pq import PqSearcher as JaxPq
from recommendflow_tpu_torch.retrieval import _kernels as tk
from recommendflow_tpu_torch.retrieval.ivf import IvfSearcher
from recommendflow_tpu_torch.retrieval.pq import PqSearcher


@pytest.fixture(scope="module")
def world():
    return tp.clustered_world()


_agree = tp.agree


# ---------------------------------------------------------------------- IVF
@pytest.mark.parametrize("metric", ["cos", "ip", "l2"])
def test_ivf_with_the_jax_quantizer_matches_jax(world, metric):
    corpus, q = world
    j = JaxIvf(32, metric, nlist=32, nprobe=4, cap_factor=1.5).train(corpus)
    t = IvfSearcher(32, metric, nlist=32, nprobe=4, cap_factor=1.5,
                    device="cpu").train(corpus,
                                        centroids=np.asarray(j._centroids))
    np.testing.assert_array_equal(t._lists.numpy(), np.asarray(j._lists))
    np.testing.assert_array_equal(t._overflow_idx, j._overflow_idx)
    assert len(t._overflow_idx) > 0            # the overflow pool is used
    _agree(j.search(q, topk=10, return_items=False),
           t.search(q, topk=10, return_items=False), 1e-5)


def test_ivf_npz_both_ways_and_full_probe_exact(world, tmp_path):
    corpus, q = world
    j = JaxIvf(32, "cos", nlist=16, nprobe=16, cap_factor=1.2,
               kmeans_iters=5, seed=3).train(corpus)
    j.save(str(tmp_path / "j.npz"))
    t = IvfSearcher.load(str(tmp_path / "j.npz"), device="cpu")
    assert (t.nlist, t.nprobe, t.cap_factor, t.kmeans_iters, t.seed) == \
        (16, 16, 1.2, 5, 3)
    t.save(str(tmp_path / "t.npz"))
    assert set(np.load(str(tmp_path / "t.npz")).files) == \
        set(np.load(str(tmp_path / "j.npz")).files)
    back = JaxIvf.load(str(tmp_path / "t.npz"))
    exact = TpuSearcher(32, "cos").train(corpus).search(q, topk=10,
                                                        return_items=False)
    # nprobe == nlist scans every item: each equals the exact search
    for s in (j, t, back):
        _agree(exact, s.search(q, topk=10, return_items=False), 1e-5)


def test_ivf_pickle_topk_beyond_pool_and_kmeans():
    rng = np.random.RandomState(0)
    v = rng.randn(2000, 16).astype(np.float32)
    s = IvfSearcher(16, "cos", nlist=100, nprobe=1, device="cpu").train(v)
    pool = s.nprobe * int(s._lists.shape[1]) + len(s._overflow_idx)
    assert pool < 100
    scores, idx = s.search(v[:4], topk=100, return_items=False)
    assert scores.shape == idx.shape == (4, 100)
    assert np.all(scores[:, pool:] < -1e20) and np.all(idx[:, pool:] == 0)
    assert np.all(scores[:, 0] > 0.99)              # the self-match
    again = pickle.loads(pickle.dumps(s))
    np.testing.assert_array_equal(again._lists.numpy(), s._lists.numpy())
    # the stored cos vectors are normalized once more on the way back, which
    # may move their last bit (as in the JAX package)
    _agree(again.search(v[:9], topk=5, return_items=False),
           s.search(v[:9], topk=5, return_items=False), 1e-6)
    # the port's own k-means: every cluster assigned, centroids spread
    x = rng.randn(1000, 8).astype(np.float32)
    c = tk.kmeans(torch.from_numpy(x), 16, iters=5)
    assert c.shape == (16, 8) and bool(torch.isfinite(c).all())
    assign = tk._assign_blocks(torch.from_numpy(x), c, 1000, block=300)
    assert set(assign.tolist()) == set(range(16))
    assert float(c.std(0).mean()) > 0.1
    # and the assignment equals the JAX one for the same centroids
    jc = jnp.asarray(c.numpy())
    np.testing.assert_array_equal(
        assign, jk._assign_blocks(jnp.asarray(np.vstack([x, x[:1] * 0])), jc,
                                  1000, block=300))


# ----------------------------------------------------------------------- PQ
@pytest.mark.parametrize("metric", ["cos", "l2"])
def test_pq_from_jax_npz_matches_jax(world, tmp_path, metric):
    corpus, q = world
    j = JaxPq(32, metric, num_subspaces=8, item_block=1024, kmeans_iters=5,
              query_block=16).train(corpus, items=np.arange(4000) + 7)
    j.save(str(tmp_path / "j.npz"))
    t = PqSearcher.load(str(tmp_path / "j.npz"), device="cpu")
    assert (t.item_block, t.query_block, t.kmeans_iters) == (1024, 16, 5)
    np.testing.assert_array_equal(t.reconstruct(np.arange(50)),
                                  j.reconstruct(np.arange(50)))
    (ji, js, jx), (ti, ts, tx) = j.search(q, topk=10), t.search(q, topk=10)
    _agree((js, jx), (ts, tx), 1e-3)
    np.testing.assert_array_equal(ti, tx + 7)
    t.save(str(tmp_path / "t.npz"))
    back = JaxPq.load(str(tmp_path / "t.npz"))
    _agree(j.search(q, topk=10, return_items=False),
           back.search(q, topk=10, return_items=False), 1e-6)
    with pytest.raises(NotImplementedError):
        t.add(corpus[:3])


def test_pq_own_build_scans_its_reconstruction(world):
    """The port's own PQ: its top-k equals a plain scan over the corpus as
    the scan decodes it (the codebooks rounded to bf16)."""
    corpus, q = world
    t = PqSearcher(32, "ip", num_subspaces=8, item_block=512,
                   device="cpu").train(corpus)
    s, i = t.search(q, topk=10, return_items=False)
    cb16 = t._codebooks.to(torch.bfloat16).float().numpy().astype(np.float64)
    dec = tk._pq_decode_np(t._codes[:4000].numpy(), cb16)
    full = q.astype(np.float64) @ dec.T
    ref_i = np.argsort(-full, axis=1, kind="stable")[:, :10]
    _agree((np.take_along_axis(full, ref_i, 1), ref_i), (s, i), 1e-4,
           score_of=lambda r, x: full[r, x])
    again = pickle.loads(pickle.dumps(t))
    np.testing.assert_array_equal(again.search(q, topk=5, return_items=False)[1],
                                  i[:, :5])


def test_pq_helpers_match_jax():
    """_pq_encode, _build_capped_lists and the k-means-free pieces on the
    same inputs."""
    rng = np.random.RandomState(4)
    x = rng.randn(3000, 16).astype(np.float32)
    cb = rng.randn(4, 256, 4).astype(np.float32)
    np.testing.assert_array_equal(
        tk._pq_encode(x, torch.from_numpy(cb)), jk._pq_encode(x, jnp.asarray(cb)))
    assign = rng.randint(0, 37, 3000)
    for a, b in zip(tk._build_capped_lists(assign, 37, 1.3),
                    jk._build_capped_lists(assign, 37, 1.3)):
        np.testing.assert_array_equal(a, b)
    codes = rng.randint(0, 256, (5, 4)).astype(np.uint8)
    np.testing.assert_array_equal(tk._pq_decode_np(codes, cb),
                                  jk._pq_decode_np(codes, cb))
    books = tk._pq_train_codebooks(x, 4, 3, 0, torch.device("cpu"))
    assert books.shape == (4, 256, 4) and bool(torch.isfinite(books).all())
