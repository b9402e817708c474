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
    JAX's on the same tables;
  * the embed pass on a marked table (`embed_batch`): a dim group whose
    slots are all sum-pooled takes `gather_pooled_bags` (the owned rows
    reduce-scattered in the table's dtype, pooled on the example's rank,
    the pooled gradient all-gathered; its `shard.lookup` span counts
    `bags`); a group with a slot of another pooling keeps the unpooled
    exchange (no `bags`). Both against JAX's `embed_batch` on the whole
    table and the port's single-table lookup: values within f32 rounding of
    JAX's and bitwise the port's (each bag pooled as the single table's
    lookup pools it), the block's gradient against the exact sum of each row's
    occurrences, each rounded to the table's dtype (f32 within 1e-6; bf16
    within one rounding, the port summing in f32 and rounding once) and
    against JAX's.
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


def _conf_with_pooling(tmp_path, pooling):
    """demo_recall with clk_cat_ids (a dim-16 slot) pooled `pooling`."""
    if pooling == "sum":
        return tp.DEMO_CONF
    with open(tp.DEMO_CONF) as f:
        text = f.read()
    old = "user_cats,int,user,lookup,$cat_vocab,16,sum,true"
    assert old in text
    path = tmp_path / "conf.yaml"
    path.write_text(text.replace(old, old.replace(",sum,", f",{pooling},")))
    return str(path)


@pytest.mark.parametrize("pooling", ["sum", "max"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("world", [2, 4])
def test_embed_pass_on_a_sharded_table_matches_jax(pooling, dtype, world,
                                                   pool2, pool4, tmp_path):
    import jax
    import jax.numpy as jnp
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.ops.embedding import embed_batch, init_tables
    conf = _conf_with_pooling(tmp_path, pooling)
    jc, _ = tp.conf_pair(conf)
    schema = compile_schema(jc.features)
    group = schema.groups[16]
    params = init_tables(schema, jax.random.PRNGKey(0),
                         dtype=jnp.dtype(dtype))
    batch = synthetic_batch(schema, 8 * world, seed=world, zipf=1.2)
    batch["clk_item_ids"][0] = 0             # bags of pads only
    batch["clk_item_ids"][1, :, ::2] = 0     # pads inside bags
    names = [n for n in schema.order if schema.slots[n].kind == "sparse"
             and schema.slots[n].dim == 16]
    rng = np.random.RandomState(world)
    want = embed_batch(params, schema, tp.to_jax(batch))
    # the loss weighs the sum-pooled slots (a max slot's gradient lands
    # on one id of each bag)
    w = {n: rng.randn(*want[n].shape).astype(np.float32) for n in names
         if schema.slots[n].pooling.value == "sum"}
    jgrad = np.asarray(jax.grad(lambda t: sum(jnp.sum(embed_batch(
        {**params, "dim16": t}, schema, tp.to_jax(batch))[n] * w[n])
        for n in w))(params["dim16"]), np.float32)
    table = np.asarray(params["dim16"])
    # the exact gradient: each valid id's weight row rounded to the table's
    # dtype (the unpooled gather's cast to f32 rounds it; the pooled
    # backward rounds each term alike), summed in f64
    exact = np.zeros((table.size // 16, 16))
    for n in w:
        ids = batch[n]                                   # [B, H, L]
        h = schema.slots[n].num_hashes
        gw = w[n].reshape(len(ids), h, 1, 16).astype(table.dtype).astype(
            np.float64)
        gids = ids + np.asarray([group.offset_of(n, k)
                                 for k in range(h)])[None, :, None]
        valid = ids > 0
        np.add.at(exact, gids[valid], np.broadcast_to(
            gw, ids.shape + (16,))[valid])
    exact = exact.reshape(table.shape)
    # the port's single-table lookup of the whole batch
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema as tschema
    from recommendflow_tpu_torch.ops.embedding import embed_batch as tembed
    single = {k: v.numpy() for k, v in tembed(
        {k: tasks._t(np.array(v)) for k, v in params.items()},
        tschema(Configuration(conf).features),
        {k: torch.from_numpy(v) for k, v in batch.items()}).items()}
    pool = pool2 if world == 2 else pool4
    got = pool.run(tasks.embed_pass, conf,
                   {k: np.asarray(v) for k, v in params.items()}, 16, batch, w)
    rows_per, b = table.shape[0] // world, len(batch["label"]) // world
    owned_none = 0
    pack = table.shape[1] // 16
    for rank, (out, grad, spans) in enumerate(got):
        lo, hi = rank * rows_per * pack, (rank + 1) * rows_per * pack
        for n in names:
            rows = slice(rank * b, (rank + 1) * b)
            np.testing.assert_allclose(out[n], np.asarray(want[n])[rows],
                                       rtol=1e-5, atol=1e-6, err_msg=n)
            np.testing.assert_array_equal(out[n], single[n][rows], err_msg=n)
            ids = batch[n][rows]
            gids = ids + np.asarray([group.offset_of(n, k) for k in range(
                schema.slots[n].num_hashes)])[None, :, None]
            mine = (ids > 0) & (gids >= lo) & (gids < hi)
            owned_none += int(((ids > 0).any(-1) & ~mine.any(-1)).sum())
        block = slice(rank * rows_per, (rank + 1) * rows_per)
        if dtype == "float32":
            np.testing.assert_allclose(grad, exact[block], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(grad, jgrad[block], rtol=1e-5,
                                       atol=1e-6)
        else:
            assert tp.bf16_ulp_err(grad, exact[block]) <= 1.0
            np.testing.assert_array_equal(grad == 0, exact[block] == 0)
        kinds = [name for name, _ in spans]
        assert kinds == ["shard.lookup", "shard.lookup_grad"]
        n_ids = len(batch["label"]) * sum(
            schema.slots[n].num_hashes * schema.slots[n].max_len
            for n in names)
        n_bags = len(batch["label"]) * sum(schema.slots[n].num_hashes
                                           for n in names)
        if pooling == "sum":    # each id's row in the table's dtype
            assert spans[0][1] == {"ids": n_ids, "bags": n_bags,
                                   "exchange_bytes": n_ids * 4 + n_ids * 16
                                   * table.dtype.itemsize}
            assert spans[1][1] == {"exchange_bytes": n_bags * 16 * 4}
        else:                   # each id's f32 row, all-reduced
            assert spans[0][1] == {"ids": n_ids, "exchange_bytes": n_ids * 4
                                   + n_ids * 16 * 4}
    assert owned_none > 0          # a bag none of whose ids a rank owns
