"""The row-sharded embedding (parallel/sharded_embedding.py) at world 2
and 4 over gloo, against the JAX package's `sharded_gather_group` under
shard_map on 2 and 4 fake CPU devices and against the single-table gather,
for the demo_recall dim-16 group stored f32 (pack 8) and packed bf16 (pack
16).

  * values: every rank's rows equal the JAX rows bitwise (one owner per id:
    the all-reduce adds zeros), returned f32 whatever the storage dtype;
  * gradients of sum(rows * w): every rank computes the same loss, so each
    shard's gradient is world times its block of the JAX table gradient
    (the backward sums every rank's gradient: parallel/distributed.py); in
    the embed pass's form each rank's loss covers its own rows and the
    gradient is the block itself. It lands on the owner's block only, bitwise for f32, within one bf16
    rounding of the JAX bf16 sum for bf16 (JAX adds a duplicate id's
    gradients in bf16 one by one, the port sums in f32 and rounds once);
  * the embed pass's form (`gather_local_rows`: each rank its own ids,
    `mark_row_shard` on a parameter): each rank's slice of the rows and the
    same gradients;
  * shard_tables keeps 'img_*' whole; init_tables / lookup_feature against
    JAX's on the same tables.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_dist_tasks as tasks
import _torch_parity as tp


@pytest.fixture(scope="module")
def pool2(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 2)


@pytest.fixture(scope="module")
def pool4(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 4)


def _jax_world(dtype, world):
    import jax
    import jax.numpy as jnp
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.ops.embedding import init_tables
    from recommendflow_tpu.parallel.mesh import make_mesh
    jc, _ = tp.conf_pair()
    schema = compile_schema(jc.features)
    params = init_tables(schema, jax.random.PRNGKey(0), dtype=jnp.dtype(dtype))
    return schema, params, make_mesh(jax.devices()[:world])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_gather_values_and_gradients_match_jax(dtype, world, pool2,
                                                       pool4):
    import jax
    import jax.numpy as jnp
    from recommendflow_tpu.ops.embedding import gather_group
    from recommendflow_tpu.parallel.sharded_embedding import (
        shard_tables, sharded_gather_group)
    schema, params, mesh = _jax_world(dtype, world)
    group = schema.groups[16]
    table = params["dim16"]
    rng = np.random.RandomState(world)
    # hot ids repeat: duplicates meet in the backward's sum
    gids = rng.randint(0, group.total_rows, (8 * world, 6)).astype(np.int32)
    gids[:, 0] = 7
    w = rng.randn(8 * world, 6, 16).astype(np.float32)
    sharded = shard_tables(params, mesh)["dim16"]
    jrows = sharded_gather_group(mesh, "dp", sharded, group, jnp.asarray(gids))
    ref = gather_group(table, group, jnp.asarray(gids))
    jgrad = np.asarray(jax.grad(lambda t: jnp.sum(sharded_gather_group(
        mesh, "dp", t, group, jnp.asarray(gids)) * w))(sharded), np.float32)
    np.testing.assert_array_equal(np.asarray(jrows), np.asarray(ref))
    def exact(times):
        """The table gradient of world-scaled rows: each row's gradient
        rounded to the table's dtype (the backward of the gather's cast to
        f32), then the duplicates summed exactly."""
        g = (w * times).astype(ml_dtypes.bfloat16).astype(np.float64)
        out = np.zeros((table.shape[0] * table.shape[1] // 16, 16))
        np.add.at(out, gids.reshape(-1), g.reshape(-1, 16))
        return out.reshape(table.shape).astype(np.float32)
    pool = pool2 if world == 2 else pool4
    got = pool.run(tasks.sharded_gather, np.asarray(table), 16, gids, w)
    rows_per = table.shape[0] // world
    for rank, (rows, is_f32, grad, local, pgrad, pshape) in enumerate(got):
        assert is_f32 and pshape == (rows_per, table.shape[1])
        np.testing.assert_array_equal(rows, np.asarray(jrows))
        b = gids.shape[0] // world
        np.testing.assert_array_equal(local, rows[rank * b:(rank + 1) * b])
        block = jgrad[rank * rows_per:(rank + 1) * rows_per]
        # the global form: every rank's loss is the whole loss (world x);
        # the local form: the ranks' losses add up to it (1 x)
        for g, want, times in ((grad, block, world), (pgrad, block, 1)):
            if dtype == "float32":
                np.testing.assert_array_equal(g, want * times)
            else:
                assert tp.bf16_ulp_err(g, exact(times)[
                    rank * rows_per:(rank + 1) * rows_per]) <= 1.0
                np.testing.assert_array_equal(g == 0, want == 0)


def test_init_tables_and_lookup_feature_match_jax():
    """init_tables: the stored shapes and dtypes of JAX's (its numbers come
    from another generator); lookup_feature on JAX's tables: the JAX
    values (the same gather and pooling)."""
    import jax
    import jax.numpy as jnp
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.ops.embedding import init_tables as jinit
    from recommendflow_tpu.ops.embedding import lookup_feature as jlookup
    from recommendflow_tpu_torch.data.schema import compile_schema as tschema
    from recommendflow_tpu_torch.ops import init_tables, lookup_feature
    jc, tc = tp.conf_pair(networks={"table_dtype": "bfloat16"})
    js, ts = compile_schema(jc.features), tschema(tc.features)
    ts.table_dtype = "bfloat16"
    jparams = jinit(js, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tparams = init_tables(ts, torch.Generator().manual_seed(0), device="cpu")
    for k, v in jparams.items():
        assert tuple(tparams[k].shape) == v.shape and \
            tparams[k].dtype == torch.bfloat16, k
    carried = {k: tasks._t(np.asarray(v).view(ml_dtypes.bfloat16))
               for k, v in jparams.items()}
    batch = synthetic_batch(js, 16, seed=5)
    for name in js.order:
        slot = js.slots[name]
        if slot.kind != "sparse":
            continue
        want = np.asarray(jlookup(jparams, js, slot, jnp.asarray(batch[name])))
        got = lookup_feature(carried, ts, ts.slots[name],
                             torch.from_numpy(batch[name])).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
