"""Multi-process fit on the CPU over gloo (train/trainer.py): the ranks'
agreement on the preemption stop step (`_PreemptSync`), the cluster-min
epoch cap, and checkpoints that cross world sizes (train/checkpoint.py).

  * SIGTERM on rank 0 only, as it draws batch 3 of 12, preempt_window 2:
    every rank stops after the same number of steps (the window after the
    local flag), each reports the preemption, and rank 0 writes the one
    checkpoint `<dir>/<step>.pt`; the same with a row-sharded table;
  * unequal dataset lengths (5 and 7 batches a rank, then 5 / 6 / 7 / 8 at
    world 4): every rank runs the cluster-min a epoch, over two epochs;
    with scan_steps 2 the tail is dropped and the cap rounds to whole
    stacks (4);
  * a checkpoint of a row-sharded (and of a replicated) state saved at
    world 2 (whole tables and accumulators in the file) restores at world
    4, and at world 1 in this process without a mesh, to the saved state bitwise, and two more steps
    from it land within atol 1e-5 of the world-2 run's two more steps (f32
    sums over another partition).
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_dist_tasks as tasks


@pytest.fixture(scope="module")
def pool2(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 2)


@pytest.fixture(scope="module")
def pool4(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 4)


@pytest.mark.parametrize("shard", [False, True], ids=["replicated", "sharded"])
def test_one_flagged_rank_stops_every_rank_at_the_same_step(shard, pool2,
                                                            tmp_path):
    d = str(tmp_path / "preempt")
    got = pool2.run(tasks.fit_preempted, 0, 3, 2, d, [12, 12], shard)
    steps = {g[0] for g in got}
    assert len(steps) == 1, got
    step = steps.pop()
    # the signal lands while batch 3 is drawn, which prefetch may do a step
    # or two ahead; the agreed stop comes `window` steps after the local
    # flag, well before the epoch's end
    assert 2 < step < 12
    assert all(g[1] for g in got)                    # every rank preempted
    assert all(g[2] == 0 for g in got)               # no epoch-end pass
    assert got[0][3] == [f"{step}.pt"]


@pytest.mark.parametrize("world", [2, 4])
def test_unequal_lengths_are_capped_at_the_cluster_min(world, pool2, pool4):
    lengths = [5, 7] if world == 2 else [5, 6, 7, 8]
    pool = pool2 if world == 2 else pool4
    got = pool.run(tasks.fit_preempted, None, None, 2, None, lengths, False,
                   2)
    assert all(g[0] == 10 and not g[1] and g[2] == 2 for g in got), got
    got = pool.run(tasks.fit_preempted, None, None, 2, None, lengths, False,
                   1, 2)
    assert all(g[0] == 4 for g in got), got


def _single_card_resume(path, steps_after):
    """World 1 in this process, no mesh: restore the world-2 file and take
    the same global batches."""
    from recommendflow_tpu_torch import interop
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.checkpoint import restore_checkpoint
    from recommendflow_tpu_torch.train.trainer import Trainer
    conf = Configuration(tasks.DEMO_CONF)
    conf.networks.update({"tower_units": [32]})
    model, _ = build_network(conf.networks["class"], {
        "conf": conf, "dropout": 0.0, "device": "cpu", "seed": 0})
    t = Trainer(model, learning_rate=1e-3, table_update="sparse",
                device="cpu")
    batches = tasks._demo_local(0, 1, 2 + steps_after, 80, batch=64)
    state = t.init_state(batches[0])
    restore_checkpoint(path, state)
    restored = interop.flatten(interop.train_state_tree(state,
                                                        ml_dtypes.bfloat16))
    for b in batches[2:]:
        state, _ = t.train_step(state, b)
    return restored, interop.flatten(interop.train_state_tree(
        state, ml_dtypes.bfloat16))


def _close(a, b, atol):
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(np.asarray(b[k], np.float32),
                                       np.asarray(v, np.float32), rtol=0,
                                       atol=atol, err_msg=str(k))
        else:
            assert v == b[k], k


@pytest.mark.parametrize("shard", [True, False], ids=["sharded",
                                                      "replicated"])
def test_checkpoint_crosses_world_sizes(shard, pool2, pool4, tmp_path):
    path = str(tmp_path / "w2.pt")
    a = pool2.run(tasks.ckpt_world, shard, path, 2, 2, "save")
    final2, saved2, step2 = a[0]
    assert step2 == 4 and a[1][0].keys() == final2.keys()
    whole = torch.load(path, weights_only=True)
    assert whole["model"]["embedder.table_dim16"].shape == (15104, 128)
    assert whole["table_acc"]["dim16"].shape == (15104, 1)
    b = pool4.run(tasks.ckpt_world, shard, path, 2, 2, "resume")
    for final4, _, step4 in b:
        assert step4 == 4
        _close(final2, final4, 1e-5)
    restored1, final1 = _single_card_resume(path, 2)
    _close(saved2, restored1, 0.0)
    _close(final2, final1, 1e-5)
