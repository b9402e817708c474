"""The port's shared retrieval pieces against the JAX package's on the same
inputs (CPU): the pairwise distances of the six distance metrics (within
1e-5: f32 sums in another order), the tournament select with the SQ8
affine base over uint8 codes (scores within 1e-4, the same ids), and the
host copy of a bf16 tensor."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp  # noqa: F401  (pins torch threads)
from recommendflow_tpu.retrieval import _kernels as jk
from recommendflow_tpu_torch.retrieval import _kernels as tk


@pytest.mark.parametrize("metric", list(tk._DISTANCE_METRICS))
def test_pairwise_distance_matches_jax(metric):
    rng = np.random.RandomState(0)
    q = rng.rand(7, 20).astype(np.float32)
    v = rng.rand(33, 20).astype(np.float32)
    v[3] = 0.0                       # zero terms: canberra's and JS's guards
    q[1, :5] = 0.0
    got = tk._make_pairwise_distance(metric, 2.5)(torch.from_numpy(q),
                                                  torch.from_numpy(v))
    want = jk._make_pairwise_distance(metric, 2.5)(jnp.asarray(q), jnp.asarray(v))
    assert got.shape == (7, 33)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not a distance metric"):
        tk._make_pairwise_distance("ip", 3.0)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_tournament_select_with_base_matches_jax(metric):
    """SqSearcher's rescore: uint8 code groups widened to the query dtype,
    the per-query base q·vmin added before the l2 surrogate."""
    rng = np.random.RandomState(1)
    G, n_groups, d, k = tk._GROUP, 16 * 64, 24, 10
    codes = rng.randint(0, 256, (n_groups * G, d)).astype(np.uint8)
    vmin = rng.randn(d).astype(np.float32)
    scale = (rng.rand(d).astype(np.float32) + 0.5) / 255
    q = rng.randn(6, d).astype(np.float32)
    qs = q * scale
    base = q @ vmin
    xhat = vmin + scale * codes.astype(np.float32)
    sqn = (xhat ** 2).sum(-1).astype(np.float32)
    valid = n_groups * G - 21
    s = qs @ codes.astype(np.float32).T
    if metric == "l2":
        s = 2 * s - sqn
    s[:, valid:] = tk.NEG
    m1 = s.reshape(6, n_groups, G).max(-1)
    args_t = (torch.from_numpy(qs), torch.from_numpy(m1),
              torch.from_numpy(codes).view(n_groups, G, d),
              torch.from_numpy(sqn).view(n_groups, G), k, k, valid, metric)
    ts, ti = tk._tournament_select(*args_t, base=torch.from_numpy(base))
    js, ji = jk._tournament_select(
        jnp.asarray(qs), jnp.asarray(m1),
        jnp.asarray(codes).reshape(n_groups, G, d),
        jnp.asarray(sqn).reshape(n_groups, G), k, k, valid, metric,
        base=jnp.asarray(base))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the exact top-k over x̂ (the surrogate for l2)
    full = q.astype(np.float64) @ xhat.T.astype(np.float64)
    if metric == "l2":
        full = 2 * full - sqn
    full[:, valid:] = -np.inf
    want = np.sort(full, axis=1)[:, ::-1][:, :k]
    np.testing.assert_allclose(ts.numpy(), want, rtol=0, atol=1e-4)


def test_to_host_widens_bf16():
    x = torch.tensor([1.5, -2.25, 3.0]).to(torch.bfloat16)
    h = tk._to_host(x)
    assert h.dtype == np.float32 and h.tolist() == [1.5, -2.25, 3.0]
    assert tk._to_host(torch.arange(3, dtype=torch.uint8)).dtype == np.uint8
