"""The port's embedding engine and gather_rows' plain version against the JAX
package: gathers exact (bitwise), pooled f32 at rtol = atol = 1e-6 (the
same sums of the same f32 values, taken by another library)."""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_parity as tp
from recommendflow_tpu.config.proto import FeaturePooling
from recommendflow_tpu.ops import embedding as jemb
from recommendflow_tpu_torch.interop import to_tensor
from recommendflow_tpu_torch.ops import embedding as temb

POOLINGS = list(FeaturePooling)


@pytest.fixture(scope="module")
def schemas():
    from recommendflow_tpu.data.schema import compile_schema as jcompile
    from recommendflow_tpu_torch.data.schema import compile_schema as tcompile
    jc, tc = tp.conf_pair()
    return jcompile(jc.features), tcompile(tc.features)


def _stored_table(rng, group, dtype):
    """Random table in the JAX stored layout, as numpy in `dtype`."""
    shape = jemb.table_shape(group, jnp.dtype(dtype))
    t = rng.uniform(-1, 1, size=shape).astype(np.float32)
    return t.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else t


def _batch(schema, B=6, seed=1):
    from recommendflow_tpu.data.synthetic import synthetic_batch
    b = synthetic_batch(schema, B, seed=seed)
    rng = np.random.RandomState(seed)
    for name in schema.order:
        s = schema.slots[name]
        if s.kind == "sparse":            # pad holes mid-sequence too
            b[name] = np.where(rng.rand(*b[name].shape) < 0.3, 0, b[name])
    return b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_layout_helpers_match(schemas, dtype):
    js, ts = schemas
    for dim in (8, 16, 32, 64, 128, 48, 256):
        assert temb.pack_factor(dim, dtype) == jemb.pack_factor(dim, jnp.dtype(dtype))
    for dim in js.groups:
        jg, tg = js.groups[dim], ts.groups[dim]
        assert temb.padded_rows(tg, dtype) == jemb.padded_rows(jg, jnp.dtype(dtype))
        assert temb.table_shape(tg, dtype) == jemb.table_shape(jg, jnp.dtype(dtype))
        t = temb.init_group_table(torch.Generator().manual_seed(0), tg, dtype,
                                  device="cpu")
        assert tuple(t.shape) == jemb.table_shape(jg, jnp.dtype(dtype))
        flat = t.view(-1, dim).float()
        assert float(flat[list(tg.offsets)].abs().max()) == 0.0
        # the scale as the table's dtype holds it (bf16 rounds 0.05 up)
        assert float(flat.abs().max()) <= float(torch.tensor(
            0.05, dtype=temb.torch_dtype(dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_group_bitwise(schemas, dtype):
    js, ts = schemas
    rng = np.random.RandomState(0)
    for dim, jg in js.groups.items():
        table = _stored_table(rng, jg, dtype)
        rows = table.shape[0] * table.shape[1] // dim
        ids = rng.randint(0, jg.total_rows, size=(5, 2, 7)).astype(np.int32)
        ids[0, 0, 0], ids[-1, -1, -1] = 0, jg.total_rows - 1
        assert jg.total_rows <= rows
        a = np.asarray(jemb.gather_group(jnp.asarray(table), jg, jnp.asarray(ids)))
        b = temb.gather_group(to_tensor(table), ts.groups[dim],
                              torch.from_numpy(ids)).numpy()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pooling", POOLINGS, ids=[p.value for p in POOLINGS])
def test_pool_sequence_all_poolings(pooling):
    from recommendflow_tpu_torch.config.proto import FeaturePooling as TPool
    rng = np.random.RandomState(2)
    emb = rng.randn(4, 2, 6, 8).astype(np.float32)
    mask = rng.rand(4, 2, 6) < 0.6
    mask[0, 0] = False                        # an all-pad row
    mask[1, 1] = [False, False, True, False, True, False]   # holes
    a = np.asarray(jemb.pool_sequence(jnp.asarray(emb), jnp.asarray(mask), pooling))
    b = temb.pool_sequence(torch.from_numpy(emb), torch.from_numpy(mask),
                           TPool(pooling.value)).numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_batch_and_concat_match(schemas, dtype):
    js, ts = schemas
    rng = np.random.RandomState(3)
    tables = {f"dim{d}": _stored_table(rng, g, dtype) for d, g in js.groups.items()}
    batch = _batch(js)
    jout = jemb.embed_batch({k: jnp.asarray(v) for k, v in tables.items()}, js,
                            tp.to_jax(batch))
    tout = temb.embed_batch({k: to_tensor(v) for k, v in tables.items()}, ts,
                            tp.to_torch(batch))
    assert sorted(jout) == sorted(tout)
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for tower in ("user", "ad"):
        np.testing.assert_allclose(
            temb.concat_tower(tout, ts, tower).numpy(),
            np.asarray(jemb.concat_tower(jout, js, tower)), rtol=1e-6, atol=1e-6)
    # the fused id plan and its stored-row view
    jf = jemb.fused_group_ids(js, tp.to_jax(batch))
    tf = temb.fused_group_ids(ts, tp.to_torch(batch))
    assert sorted(jf) == sorted(tf)
    for d in jf:
        np.testing.assert_array_equal(np.asarray(jf[d]), tf[d].numpy())
        t = to_tensor(tables[f"dim{d}"])
        np.testing.assert_array_equal(
            np.asarray(jemb.physical_ids(jnp.asarray(tables[f"dim{d}"]), d, jf[d])),
            temb.physical_ids(t, d, tf[d]).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_plain_matches_pallas_interpret(dtype):
    from recommendflow_tpu.ops.pallas.embedding_bag import gather_rows as pallas
    from recommendflow_tpu_torch.ops.cuda.embedding_bag import (
        gather_rows, gather_rows_plain)
    rng = np.random.RandomState(4)
    table = rng.randn(300, 64).astype(np.float32)
    if dtype == "bfloat16":
        table = table.astype(ml_dtypes.bfloat16)
    ids = rng.randint(0, 300, size=700).astype(np.int32)   # > one Pallas chunk
    ids[:3] = [0, 299, 0]
    a = np.asarray(pallas(jnp.asarray(table), jnp.asarray(ids), interpret=True))
    t = to_tensor(table)
    b = gather_rows_plain(t, torch.from_numpy(ids))
    c = gather_rows(t, torch.from_numpy(ids))      # CPU tensor -> plain version
    if dtype == "bfloat16":
        np.testing.assert_array_equal(tp.bf16_bits(a), tp.bf16_bits(b))
    else:
        np.testing.assert_array_equal(a, b.numpy())
    assert torch.equal(b, c)
