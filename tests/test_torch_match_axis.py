"""The in-batch losses' `axis_name` path (losses/match.py) and
`auc_update(axis_name=)` at world 2 and 4 over gloo: each rank holds its
own rows of a global batch of 32 (numpy, from a seed).

  * value: every rank returns the global batch's loss, within rtol 1e-5 of
    the JAX loss on the whole batch (unsharded) and of the JAX loss under
    shard_map on 2 / 4 fake devices with the same axis_name (f32 sums over
    another partition);
  * gradients: each rank's gradient of its query, doc (and logQ) rows is
    world times its rows of the JAX gradient of the global loss
    (parallel/distributed.py: every rank's loss is the global loss and the
    all-gather's backward sums them), within rtol 1e-5, atol 1e-6;
  * `global_batch_loss` on a loss without an axis path (CoSENT): the
    all-gathered inputs give the global value and the same gradients;
  * auc_update: every rank's counts are the JAX counts of the global batch,
    bitwise.
"""
import numpy as np
import pytest

import _torch_dist
import _torch_dist_tasks as tasks

B, DIM = 32, 8
LOSSES = [
    ("batch_neg_sample_ce_loss", False, {}),
    ("batch_neg_sample_symmetrical_ce_loss", False, {}),
    ("batch_neg_sample_scaled_multi_class_ce_loss", False, {}),
    ("batch_neg_sample_scaled_multi_class_ce_loss", True, {}),
    ("batch_neg_sample_symmetrical_scaled_multi_class_ce_loss", True,
     {"scale": 10.0}),
    ("batch_neg_sample_margin_rank_loss", False, {}),
    ("batch_hard_neg_sample_margin_rank_loss", False, {}),
    ("batch_softmax_probabilistic_combining_soft", False, {}),
    ("global:cosent_loss", False, {}),
]


@pytest.fixture(scope="module")
def pool2(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 2)


@pytest.fixture(scope="module")
def pool4(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 4)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    q, d = unit(rng.randn(B, DIM)), unit(rng.randn(B, DIM))
    y = (rng.rand(B) > 0.2).astype(np.float32)
    logq = np.log(rng.rand(B) * 0.5 + 0.01).astype(np.float32)
    return y, q, d, logq


def _jax_fn(name):
    from recommendflow_tpu.losses import match as jm
    if name.startswith("global:"):
        return getattr(jm, name[7:])
    fn = getattr(jm, name)
    return fn(B) if name == "batch_softmax_probabilistic_combining_soft" \
        else fn


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,with_logq,kwargs", LOSSES,
                         ids=[f"{n}{'-logq' if lq else ''}"
                              for n, lq, _ in LOSSES])
def test_axis_loss_matches_jax(world, name, with_logq, kwargs, pool2, pool4):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from recommendflow_tpu.parallel.mesh import make_mesh
    y, q, d, logq = _inputs(world)
    lq = logq if with_logq else None
    jfn = _jax_fn(name)
    extra = dict(kwargs)

    def glob(q_, d_, l_):
        kw = dict(extra, **({"logq": l_} if with_logq else {}))
        return jfn(jnp.asarray(y), q_, d_, **kw)
    jv, (gq, gd, gl) = jax.value_and_grad(glob, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(d), jnp.asarray(logq))
    if not name.startswith("global:"):
        mesh = make_mesh(jax.devices()[:world])
        spec = P("dp")

        def body(y_, q_, d_, l_):
            kw = dict(extra, **({"logq": l_} if with_logq else {}))
            return jfn(y_, q_, d_, axis_name="dp", **kw)
        sv = jax.shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                           out_specs=P(), check_vma=False)(
            jnp.asarray(y), jnp.asarray(q), jnp.asarray(d), jnp.asarray(logq))
        np.testing.assert_allclose(float(sv), float(jv), rtol=1e-5)
    pool = pool2 if world == 2 else pool4
    got = pool.run(tasks.axis_loss, name, y, q, d, lq, kwargs)
    b = B // world
    for rank, (v, tq, td, tl) in enumerate(got):
        sl = slice(rank * b, (rank + 1) * b)
        np.testing.assert_allclose(v, float(jv), rtol=1e-5)
        np.testing.assert_allclose(tq / world, np.asarray(gq)[sl], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(td / world, np.asarray(gd)[sl], rtol=1e-5,
                                   atol=1e-6)
        if with_logq:
            np.testing.assert_allclose(tl / world, np.asarray(gl)[sl],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_auc_update_sums_the_global_batch(world, pool2, pool4):
    import jax.numpy as jnp
    from recommendflow_tpu.train import metrics as jmet
    rng = np.random.RandomState(7)
    y = (rng.rand(64) > 0.5).astype(np.float32)
    score = rng.rand(64).astype(np.float32)
    want = jmet.auc_update(jmet.auc_init(), jnp.asarray(y), jnp.asarray(score))
    got = (pool2 if world == 2 else pool4).run(tasks.axis_auc, y, score)
    for counts, auc in got:
        for a, b in zip(counts, want):
            np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_allclose(auc, float(jmet.auc_result(want)),
                                   rtol=1e-6)
