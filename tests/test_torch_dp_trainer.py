"""The data-parallel Trainer (`Trainer(mesh=, shard_tables=)`) at world 2
and 4 over gloo, against the JAX Trainer on a mesh of 2 and 4 fake CPU
devices (pjit over the global batch).

Both start from the same carried TrainState (the JAX state after one step,
tables included: each port rank loads its block of a row-sharded table),
take the same three demo_recall batches of 64 (each port rank its
contiguous rows: `shard_batch`) with dropout 0, and are compared step by
step (the loss every rank reports) and at the end (the whole state,
gathered from the ranks), at tests/test_torch_train.py's tolerances for
f32 tables: losses rtol 1e-5, every float leaf atol 1e-5 (the same f32
arithmetic, summed over another partition: BatchNorm's global moments from
all-reduced sums, gradients averaged over the ranks). Replicated tables
take the split path ("dense", "sparse_set") or the legacy updates
("dense", "sparse"); shard_tables=True shards the dim-16 group (15,104
stored rows; the 256-row dim-8 group stays whole) and takes the legacy
updates, as in the JAX trainer. After the steps every replicated weight,
buffer, accumulator and Adam moment is bitwise equal across the ranks.
"""
import numpy as np
import pytest

import _torch_dist
import _torch_dist_tasks as tasks
import _torch_parity as tp

NETS = {"tower_units": [64, 32]}
CASES = [  # (world, table_update, split strategy, shard_tables)
    (2, "split", "dense", False), (2, "split", "sparse_set", False),
    (2, "dense", "auto", False), (2, "sparse", "auto", False),
    (2, "sparse", "auto", True), (2, "dense", "auto", True),
    (4, "split", "sparse_set", False), (4, "sparse", "auto", True)]


@pytest.fixture(scope="module")
def pool2(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 2)


@pytest.fixture(scope="module")
def pool4(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 4)


def _batches():
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    jc, _ = tp.conf_pair(networks=NETS)
    return [synthetic_batch(compile_schema(jc.features), 64, seed=40 + i)
            for i in range(4)]


def _jax_run(world, mode, strategy, shard, batches):
    import jax
    from recommendflow_tpu.models.base import build_network
    from recommendflow_tpu.parallel.mesh import make_mesh
    from recommendflow_tpu.train.trainer import Trainer
    jc, _ = tp.conf_pair(networks=NETS)
    model, _ = build_network(jc.networks["class"], {"conf": jc,
                                                    "dropout": 0.0})
    t = Trainer(model, learning_rate=1e-3, table_update=mode, seed=0,
                mesh=make_mesh(jax.devices()[:world]), shard_tables=shard)
    state = t.init_state(t._put(batches[0]))
    if mode == "split":
        assert t._split_dims
        t._split_dims = {d: strategy for d in t._split_dims}
    state, _ = t.train_step(state, batches[0])          # a non-trivial state
    tree = tp.jax_state_tree(state)
    losses = []
    for b in batches[1:]:
        state, m = t.train_step(state, b)
        losses.append(float(m["loss"]))
    return t, tree, losses, tp.flat_tree(tp.jax_state_tree(state))


@pytest.mark.parametrize("world,mode,strategy,shard", CASES,
                         ids=[f"w{w}-{m}-{s}{'-sharded' if sh else ''}"
                              for w, m, s, sh in CASES])
def test_steps_match_the_jax_mesh_trainer(world, mode, strategy, shard,
                                          pool2, pool4):
    batches = _batches()
    jt, tree, jl, jfin = _jax_run(world, mode, strategy, shard, batches)
    pool = pool2 if world == 2 else pool4
    got = pool.run(tasks.dp_steps, NETS, mode, strategy, shard, tree,
                   batches)
    digests = got[0][2]
    for rank, (tl, flat, dig, split, sparse, sharded) in enumerate(got):
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"rank {rank}")
        assert dig == digests, f"rank {rank}: replicas differ"
        if mode == "split":
            assert set(split.values()) == {strategy} and not sparse
        else:
            assert not split
            assert sorted(sparse) == ([8, 16] if mode == "sparse" else [])
        assert sharded == (["embedder.table_dim16"] if shard else [])
        tfin = {"/".join(k): v for k, v in flat.items()}
        assert sorted(tfin) == sorted(jfin)
        for k, a in jfin.items():
            b = tfin[k]
            if not isinstance(a, np.ndarray):
                assert a == b, k
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5,
                                           err_msg=f"rank {rank}: {k}")


@pytest.mark.parametrize("extra", [["--shard_tables"], []],
                         ids=["shard_tables", "replicated"])
def test_train_cli_on_a_mesh(extra, pool2, tmp_path):
    """cli/train in two processes of one group (as under torchrun): each
    rank reads its own record file, both run the same steps and report the
    same epoch metrics (the global batch's), --shard_tables shards the
    dim-16 group, and rank 0 writes the whole tables to ckpt/final.pt."""
    import os
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import generate_records
    generate_records(Configuration(tp.DEMO_CONF), str(tmp_path / "rec"),
                     num_rows=640, num_files=2, seed=5)
    data = os.path.join(str(tmp_path / "rec"), "*.rfb")
    got = pool2.run(tasks.train_cli, data, str(tmp_path / "m"), extra)
    (s0, sh0, h0, shape), (s1, sh1, h1, _) = got
    assert s0 == s1 == 2 * 10 and sh0 == sh1
    assert sh0 == (["embedder.table_dim16"] if extra else [])
    h0.pop("examples_per_sec")
    h1.pop("examples_per_sec")
    assert h0 == h1 and "loss" in h0
    assert shape == (15104, 128)


@pytest.mark.parametrize("world", [2, 4])
def test_mmoe_shard_experts_matches_jax(world, pool2, pool4):
    """Mmoe (4 experts) on demo_ranking with shard_experts over a ('dp',
    'ep') mesh of (world / 2, 2): each rank holds 2 experts (every expert
    leaf [2, ...]), three split "sparse_set" steps from a carried JAX state
    against the JAX trainer's expert-sharded mesh, at the same tolerances;
    the replicated leaves bitwise equal across the ranks. A mesh without
    'ep' is refused."""
    import jax
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.parallel.mesh import make_mesh
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from test_torch_ranking import MODELS, RANK_CONF
    path, kw = MODELS["mmoe"]
    kw = dict(kw, dropout=0.0, num_experts=4)
    jc, _ = tp.conf_pair(RANK_CONF)
    batches = [synthetic_batch(compile_schema(jc.features), 64, seed=60 + i)
               for i in range(4)]
    jmodel, _ = jbuild(path, {"conf": jc, **kw})
    jt = JTrainer(jmodel, learning_rate=1e-3, table_update="split", seed=0,
                  mesh=make_mesh(jax.devices()[:world], ("dp", "ep"),
                                 (world // 2, 2)), shard_experts=True)
    js = jt.init_state(jt._put(batches[0]))
    jt._split_dims = {d: "sparse_set" for d in jt._split_dims}
    js, _ = jt.train_step(js, batches[0])
    tree = tp.jax_state_tree(js)
    jl = []
    for b in batches[1:]:
        js, m = jt.train_step(js, b)
        jl.append(float(m["loss"]))
    jfin = tp.flat_tree(tp.jax_state_tree(js))
    pool = pool2 if world == 2 else pool4
    got = pool.run(tasks.expert_steps, path, kw, tree, batches, RANK_CONF)
    for rank, (tl, flat, dig, blocks) in enumerate(got):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert dig == got[0][2], f"rank {rank}: replicas differ"
        assert blocks and all(s[0] == 2 for s in blocks.values())
        assert all(".experts." in n for n in blocks)
        tfin = {"/".join(k): v for k, v in flat.items()}
        assert sorted(tfin) == sorted(jfin)
        for k, a in jfin.items():
            if isinstance(a, np.ndarray):
                np.testing.assert_allclose(tfin[k], a, rtol=0, atol=1e-5,
                                           err_msg=f"rank {rank}: {k}")
            else:
                assert tfin[k] == a, k
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer
    _, tc = tp.conf_pair(RANK_CONF)
    model, _ = build_network(path, {"conf": tc, "device": "cpu", **kw})

    class NoEp:
        shape, axis_names, device = {"dp": 1}, ("dp",), "cpu"
    with pytest.raises(ValueError, match="'ep'"):
        Trainer(model, device="cpu", mesh=NoEp(), shard_experts=True)


@pytest.mark.parametrize("shard", [False, True], ids=["replicated",
                                                      "sharded"])
def test_predict_and_evaluate_return_the_global_batch(shard, pool2):
    """Each rank passes its rows; every rank's predict returns the global
    batches' outputs in order and evaluate the global metrics: equal to one
    process's predict and evaluate of the global batches (the same seeded
    weights; eval mode reads the running statistics)."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer
    conf = Configuration(tp.DEMO_CONF)
    conf.networks.update({"tower_units": [32]})
    batches = [synthetic_batch(compile_schema(conf.features), 32, seed=90 + i)
               for i in range(3)]
    model, _ = build_network(conf.networks["class"], {
        "conf": conf, "dropout": 0.0, "device": "cpu", "seed": 0})
    t = Trainer(model, table_update="sparse", device="cpu")
    state = t.init_state(batches[0])
    want, want_logs = t.predict(state, batches), t.evaluate(state, batches)
    for out, logs in pool2.run(tasks.dp_predict, batches, shard):
        assert sorted(out) == sorted(want)
        for k in want:
            np.testing.assert_allclose(out[k], want[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        assert logs.keys() == want_logs.keys()
        for k in want_logs:
            assert logs[k] == pytest.approx(want_logs[k], rel=1e-6), k
