"""The port's parallel layer on the CPU (parallel/distributed.py,
parallel/mesh.py): gloo processes at world 2 and 4 (tests/_torch_dist.py)
against the JAX package's functions on meshes of 2 and 4 of the 8 fake CPU
devices.

  * make_mesh: axis sizes and each rank's coordinates, as the JAX mesh lays
    its devices out (row-major);
  * table_sharding_rules (>= 8192 stored rows that the axis divides),
    expert_sharding_rules (and its refusal of a mesh without 'ep'),
    merge_rules and apply_shardings: the same specs as JAX's, the shards'
    shapes the JAX shards';
  * shard_batch: each rank's rows are the rows of the JAX P('dp') shard on
    device rank;
  * the differentiable collectives: the all-gather's backward sums each
    slice's gradient over the ranks, the all-reduce's likewise;
  * init_distributed: a no-op without the environment, a raise when a
    requested multi-process init cannot complete.
"""
import numpy as np
import pytest

import _torch_dist
import _torch_dist_tasks as tasks


@pytest.fixture(scope="module")
def pool2(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 2)


@pytest.fixture(scope="module")
def pool4(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 4)


def _pool(world, pool2, pool4):
    return pool2 if world == 2 else pool4


SHAPES = {"embedder/table_dim16": (15104, 128), "embedder/table_dim8": (256, 128),
          "embedder/table_dim32": (8190, 128), "tower/Dense_0/kernel": (64, 32),
          "experts/Dense_0/kernel": (4, 8, 16), "experts/Dense_0/bias": (4, 16),
          "gate/kernel": (16, 4)}


def _jax_specs(rules_fn, world, axes, shape):
    import jax
    from jax.sharding import PartitionSpec as P
    from recommendflow_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(jax.devices()[:world], axes, shape)
    params = {k: np.zeros(v, np.float32) for k, v in SHAPES.items()}
    tree = {}
    for k, v in params.items():
        node = tree
        *mods, leaf = k.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    specs = rules_fn(tree, mesh)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): tuple(s)
            for path, s in flat}


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_lays_out_ranks_as_jax(world, pool2, pool4):
    import jax
    from recommendflow_tpu.parallel.mesh import make_mesh
    pool = _pool(world, pool2, pool4)
    for axes, shape in ((("dp",), None), (("dp", "ep"), (world // 2, 2))):
        got = pool.run(tasks.mesh_layout, axes, shape)
        jm = make_mesh(jax.devices()[:world], axes, shape)
        ids = np.asarray([d.id for d in jm.devices.flat]).reshape(
            jm.devices.shape)
        for rank, (sizes, coords) in enumerate(got):
            assert sizes == dict(jm.shape)
            where = np.argwhere(ids == jax.devices()[rank].id)[0]
            assert coords == dict(zip(axes, map(int, where)))


@pytest.mark.parametrize("world", [2, 4])
def test_table_and_expert_rules_match_jax(world, pool2, pool4):
    from recommendflow_tpu.parallel.mesh import (expert_sharding_rules,
                                                 table_sharding_rules)
    pool = _pool(world, pool2, pool4)
    got = pool.run(tasks.sharding_rules, SHAPES, ("dp",), None, "table")
    want = _jax_specs(table_sharding_rules, world, ("dp",), None)
    assert all(g == want for g in got)
    assert want["embedder/table_dim16"] == ("dp", None)
    assert want["embedder/table_dim8"] == ()          # fewer than 8192 rows
    axes, shape = ("dp", "ep"), (world // 2, 2)
    got = pool.run(tasks.sharding_rules, SHAPES, axes, shape, "expert")
    want = _jax_specs(expert_sharding_rules, world, axes, shape)
    assert all(g == want for g in got)
    assert want["experts/Dense_0/kernel"] == ("ep", None, None)
    # no 'ep' axis: refused by both
    got = pool.run(tasks.sharding_rules, SHAPES, ("dp",), None, "expert")
    assert all(g.startswith("ValueError") and "'ep'" in g for g in got)
    with pytest.raises(ValueError, match="'ep'"):
        _jax_specs(expert_sharding_rules, world, ("dp",), None)


def test_merge_rules_and_apply_shardings(pool4):
    """merge_rules: the first non-replicated spec wins; apply_shardings
    keeps each rank's block of a sharded leaf, the whole of the rest."""
    got = pool4.run(tasks.sharding_rules, SHAPES, ("dp", "ep"), (2, 2),
                    "merge")
    for specs, shapes in got:
        assert specs["embedder/table_dim16"] == ("dp", None)
        assert specs["embedder/table_dim8"] == ("dp", None)   # min_rows 8
        assert specs["experts/Dense_0/kernel"] == ("ep", None, None)
        assert specs["gate/kernel"] == ()
        assert shapes["embedder/table_dim16"] == (7552, 128)
        assert shapes["experts/Dense_0/bias"] == (2, 16)
        assert shapes["gate/kernel"] == (16, 4)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_is_the_jax_dp_layout(world, pool2, pool4):
    import jax
    from recommendflow_tpu.parallel.mesh import make_mesh
    from recommendflow_tpu.parallel.mesh import shard_batch as jsb
    rng = np.random.RandomState(3)
    batch = {"ids": rng.randint(0, 99, (16, 2, 3)).astype(np.int32),
             "label": rng.rand(16).astype(np.float32)}
    got = _pool(world, pool2, pool4).run(tasks.shard_batch, batch)
    jmesh = make_mesh(jax.devices()[:world])
    placed = jsb(jmesh, batch)
    for k, arr in placed.items():
        by_dev = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
        for rank in range(world):
            np.testing.assert_array_equal(got[rank][k],
                                          by_dev[jax.devices()[rank].id])


@pytest.mark.parametrize("world", [2, 4])
def test_differentiable_collectives(world, pool2, pool4):
    """all_gather: forward the rank-ordered concatenation; backward each
    rank's slice of the SUM of every rank's gradient (here every rank's
    gradient is arange over the gathered rows). all_reduce_sum: the sum;
    backward the sum of the ranks' gradients (rank + 1 each)."""
    got = _pool(world, pool2, pool4).run(tasks.collectives)
    gathered = np.concatenate([np.full((2, 3), r + 1.0) for r in range(world)])
    total = sum(range(1, world + 1))
    for rank, (y, gx, s, gz, hid, nh) in enumerate(got):
        np.testing.assert_array_equal(y, gathered)
        want = world * np.arange(2 * rank, 2 * rank + 2, dtype=np.float32)
        np.testing.assert_array_equal(gx, np.repeat(want[:, None], 3, 1))
        np.testing.assert_array_equal(s, np.full(3, total))
        np.testing.assert_array_equal(gz, np.full(3, total))
        assert (hid, nh) == (rank, world)


def test_init_distributed_without_environment(monkeypatch, tmp_path):
    """No environment and no arguments: nothing is initialized, the device
    is the one asked for; make_mesh then refuses. A requested init of two
    processes with one present raises (gloo's store times out), and no
    group is left behind."""
    import torch.distributed as dist
    from recommendflow_tpu_torch.parallel import (init_distributed, make_mesh,
                                                  host_id, num_hosts)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert str(init_distributed(device="cpu")) == "cpu"
    assert not dist.is_initialized() and (host_id(), num_hosts()) == (0, 1)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    with pytest.raises(Exception):
        init_distributed(0, 2, "file://" + str(tmp_path / "init"),
                         device="cpu", timeout_s=2)
    assert not dist.is_initialized()
