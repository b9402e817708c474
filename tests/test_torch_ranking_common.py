"""The ranking models' shared helpers (models/common.py) and the
interaction layers (ops/interactions.py) against the JAX package: the same
numpy inputs from a seed, the same weights carried through interop.py, and
outputs within 1e-6 (f32 sums in another order; relative 1e-6 where the
values exceed 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

RANK_CONF = f"{tp.ROOT}/conf/demo_ranking.yaml"
BENCH_RANK_CONF = f"{tp.ROOT}/conf/bench_ranking.yaml"
TOL = dict(rtol=1e-6, atol=1e-6)


def _schemas(path):
    from recommendflow_tpu.data.schema import compile_schema as jcompile
    from recommendflow_tpu_torch.data.schema import compile_schema as tcompile
    jc, tc = tp.conf_pair(path)
    return jcompile(jc.features), tcompile(tc.features)


def _features(schema, b=6, seed=0):
    """Pooled-feature dicts as embed_batch makes them, random, numpy."""
    rng = np.random.RandomState(seed)
    return {s.name: rng.randn(b, s.out_dim).astype(np.float32)
            for s in (schema.slots[n] for n in schema.order) if s.out_dim}


@pytest.mark.parametrize("path", [RANK_CONF, BENCH_RANK_CONF],
                         ids=["demo_ranking", "bench_ranking"])
def test_input_assembly_matches_jax(path):
    from recommendflow_tpu.models import common as jcommon
    from recommendflow_tpu_torch.models import common as tcommon
    js, ts = _schemas(path)
    assert [s.name for s in tcommon.input_slots(ts)] == \
        [s.name for s in jcommon.input_slots(js)]
    feats = _features(ts)
    jx = jcommon.concat_all({k: jnp.asarray(v) for k, v in feats.items()}, js)
    tx = tcommon.concat_all(tp.to_torch(feats), ts)
    assert tx.shape[1] == tcommon.input_dim(ts)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    jf, jnames = jcommon.field_stack({k: jnp.asarray(v) for k, v in
                                      feats.items()}, js)
    tf, tnames = tcommon.field_stack(tp.to_torch(feats), ts)
    assert tnames == jnames and tuple(tf.shape[1:]) == tcommon.field_shape(ts)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    if path == BENCH_RANK_CONF:          # two fields per hashing feature
        assert tnames[:3] == ["c01#0", "c01#1", "c02#0"] and len(tnames) == 52


def test_labels_and_bce_match_jax():
    from recommendflow_tpu.models import common as jcommon
    from recommendflow_tpu_torch.models import common as tcommon
    js, ts = _schemas(RANK_CONF)
    rng = np.random.RandomState(1)
    y = (rng.rand(32) > 0.5).astype(np.float32)
    logits = (rng.randn(32) * 3).astype(np.float32)
    p = 1 / (1 + np.exp(-logits))
    p[:2] = [0.0, 1.0]                               # the clip's edges
    np.testing.assert_allclose(
        tcommon.bce_with_logits(torch.from_numpy(y), torch.from_numpy(logits)),
        jcommon.bce_with_logits(jnp.asarray(y), jnp.asarray(logits)), **TOL)
    np.testing.assert_allclose(
        tcommon.bce_probs(torch.from_numpy(y), torch.from_numpy(p)).numpy(),
        np.asarray(jcommon.bce_probs(jnp.asarray(y), jnp.asarray(p))), **TOL)
    batch = {"click": y, "price": rng.rand(32, 1).astype(np.float32)}
    (jy, jz) = jcommon.get_labels({k: jnp.asarray(v) for k, v in batch.items()},
                                  js, 2)
    (ty, tz) = tcommon.get_labels(tp.to_torch(batch), ts, 2)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert not tz.any()                              # serving zero-fills
    with pytest.raises(ValueError, match="'conversion' is missing"):
        tcommon.get_labels(tp.to_torch(batch), ts, 2, training=True)
    batch["conversion"] = y
    with pytest.raises(ValueError, match="<label #2>"):
        tcommon.get_labels(tp.to_torch(batch), ts, 3, training=True)


def _carry(jmodule, tmodule, *inputs):
    """Init the flax module on the inputs, copy its params into the torch
    module and return both outputs."""
    variables = jmodule.init(jax.random.PRNGKey(3),
                             *[jnp.asarray(x) for x in inputs])
    params = jax.tree_util.tree_map(np.asarray, dict(variables))
    interop.load_jax_variables(tmodule, params)
    back = interop.flatten(interop.jax_from_variables(tmodule.state_dict()))
    for k, v in interop.flatten(params).items():
        np.testing.assert_array_equal(back[k], v)    # carried both ways
    jout = jmodule.apply(variables, *[jnp.asarray(x) for x in inputs])
    with torch.no_grad():
        tout = tmodule(*[torch.from_numpy(x) for x in inputs])
    return np.asarray(jout), tout.numpy()


def _fields(b=5, f=6, d=4, seed=2):
    return (np.random.RandomState(seed).randn(b, f, d) * 0.5).astype(np.float32)


def test_fm_pairwise_and_fm_match_jax():
    from recommendflow_tpu.ops import interactions as ji
    from recommendflow_tpu_torch.ops import interactions as ti
    x = _fields()
    np.testing.assert_allclose(ti.fm_pairwise(torch.from_numpy(x)).numpy(),
                               np.asarray(ji.fm_pairwise(jnp.asarray(x))), **TOL)
    values = np.random.RandomState(4).rand(5, 6).astype(np.float32)
    for extra in ((), (values,)):
        j, t = _carry(ji.FM(), ti.FM(6, 4, device="cpu"), x, *extra)
        assert t.shape == (5,)
        np.testing.assert_allclose(t, j, **TOL)


def test_ffm_and_residual_units_match_jax():
    from recommendflow_tpu.ops import interactions as ji
    from recommendflow_tpu_torch.ops import interactions as ti
    x = _fields()
    j, t = _carry(ji.FFM(latent_dim=3),
                  ti.FFM(6, 4, latent_dim=3, device="cpu"), x)
    np.testing.assert_allclose(t, j, **TOL)
    v = np.random.RandomState(5).randn(7, 12).astype(np.float32)
    j, t = _carry(ji.ResidualUnits(hidden=9),
                  ti.ResidualUnits(12, 9, device="cpu"), v)
    np.testing.assert_allclose(t, j, **TOL)


def test_cross_network_matches_jax():
    from recommendflow_tpu.ops import interactions as ji
    from recommendflow_tpu_torch.ops import interactions as ti
    x = np.random.RandomState(6).randn(8, 20).astype(np.float32)
    j, t = _carry(ji.CrossNetwork(num_layers=3),
                  ti.CrossNetwork(20, 3, device="cpu"), x)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("layers,split_half,activation", [
    ((8, 6), True, "relu"), ((7, 5, 4), True, "relu"),
    ((8, 6), False, "linear"), ((5, 3), False, "relu"),
    ((6, 4), True, "linear")])
def test_cin_matches_jax(layers, split_half, activation):
    """Every CIN form: the xDeepFM variant (split halves, relu; an odd size
    forwards the larger half), the reference's raw stack (linear, no
    split), and the mixed ones."""
    from recommendflow_tpu.ops import interactions as ji
    from recommendflow_tpu_torch.ops import interactions as ti
    x = _fields()
    tm = ti.CIN(6, layers, split_half=split_half, activation=activation,
                device="cpu")
    j, t = _carry(ji.CIN(layers, split_half=split_half, activation=activation),
                  tm, x)
    assert t.shape == (5, tm.out_dim)
    np.testing.assert_allclose(t, j, **TOL)
    with pytest.raises(ValueError, match="relu|linear"):
        ti.CIN(6, layers, activation="tanh")
