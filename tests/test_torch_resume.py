"""Step-exact resume of the port's Trainer on the CPU: a run interrupted
after 2 steps, written to a checkpoint, restored into a fresh model and
Trainer and taken 2 more steps equals the run that took 4 steps without a
break, bit for bit (tables, accumulators, dense weights, Adam moments,
BatchNorm statistics), at dropout 0.3, in every table-update mode. This is
the JAX trainer's property (its dropout draws from fold_in(state.rng,
state.step), and state.rng is in the checkpoint); the masks themselves
cannot match JAX's, because the two RNG streams differ. Dssm on
demo_recall, towers 64-32, batches of 64. The checkpoint's seed wins over
the restoring Trainer's, and a checkpoint without a seed loads with the
Trainer's.
"""
import pytest
import torch

import _torch_parity as tp

NETS = {"tower_units": [64, 32]}
MODES = [("split", "dense"), ("split", "sparse_set"), ("split", "sparse"),
         ("dense", "dense"), ("sparse", "dense")]
IDS = ["split-dense", "split-sparse_set", "split-sparse", "dense", "sparse"]


def _batches(n=4):
    return tp.demo_batches(n, seed=40).batches


def _trainer(mode="split", strategy="sparse_set", seed=3, dropout=0.3):
    return tp.demo_trainer(NETS, dropout=dropout, seed=seed,
                           table_update=mode, split_strategy=strategy)


def _steps(trainer, state, batches):
    for b in batches:
        state, _ = trainer.train_step(state, b)
    return state


def _snapshot(state):
    from recommendflow_tpu_torch.train.checkpoint import state_to_host
    return state_to_host(state)


def _assert_bitwise(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), f"{path}: max diff " \
            f"{(a.float() - b.float()).abs().max().item()}"
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def _interrupted(tmp_path, batches, restore_seed=3, drop_seed=False,
                 **kw):
    from recommendflow_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)
    t = _trainer(**kw)
    s = _steps(t, t.init_state(batches[0]), batches[:2])
    path = save_checkpoint(str(tmp_path / "2.pt"), s)
    if drop_seed:        # a checkpoint written before the seed travelled
        saved = torch.load(path, weights_only=True)
        del saved["seed"]
        torch.save(saved, path)
    t2 = _trainer(**{**kw, "seed": restore_seed})
    s2 = restore_checkpoint(path, t2.init_state(batches[0]))
    assert s2.step == 2
    return _steps(t2, s2, batches[2:])


@pytest.mark.parametrize("mode,strategy", MODES, ids=IDS)
def test_restored_run_equals_the_uninterrupted_one(mode, strategy, tmp_path):
    batches = _batches()
    t = _trainer(mode, strategy)
    a = _steps(t, t.init_state(batches[0]), batches)
    if mode == "split":
        assert set(t._split_dims.values()) == {strategy}
    b = _interrupted(tmp_path, batches, mode=mode, strategy=strategy)
    assert a.step == b.step == 4 and a.seed == b.seed == 3
    _assert_bitwise(_snapshot(a), _snapshot(b))


def test_the_seed_reaches_the_masks():
    """Two runs that differ only in the Trainer's seed differ (dropout is
    live, so the bitwise resume above is not vacuous), and a run repeated
    with the same seed is equal."""
    batches = _batches(2)
    runs = []
    for seed in (3, 4, 3):
        t = _trainer(seed=seed)
        runs.append(_snapshot(_steps(t, t.init_state(batches[0]), batches)))
    _assert_bitwise(runs[0], runs[2])
    diff = max((runs[0]["model"][k].float() - runs[1]["model"][k].float()
                ).abs().max().item() for k in runs[0]["model"])
    assert diff > 1e-3


def test_step_seeds_are_distinct():
    from recommendflow_tpu_torch.train.trainer import step_seed
    seeds = {step_seed(s, k) for s in range(4) for k in range(1000)}
    assert len(seeds) == 4000 and all(0 <= x < 2 ** 64 for x in seeds)


def test_the_checkpoint_seed_wins_over_the_trainers(tmp_path):
    """A restore into a Trainer built with another seed continues the saved
    run: the state takes the checkpoint's seed."""
    batches = _batches()
    t = _trainer()
    a = _steps(t, t.init_state(batches[0]), batches)
    b = _interrupted(tmp_path, batches, restore_seed=99)
    assert b.seed == 3
    _assert_bitwise(_snapshot(a), _snapshot(b))


def test_a_checkpoint_without_a_seed_loads(tmp_path):
    """A checkpoint written before the seed travelled in it loads, and the
    state keeps the restoring Trainer's seed (here the same as the saved
    run's, so the resumed run is still the uninterrupted one)."""
    batches = _batches()
    t = _trainer()
    a = _steps(t, t.init_state(batches[0]), batches)
    b = _interrupted(tmp_path / "x", batches, drop_seed=True)
    assert b.seed == 3
    _assert_bitwise(_snapshot(a), _snapshot(b))
    c = _interrupted(tmp_path / "y", batches, restore_seed=5, drop_seed=True)
    assert c.seed == 5
    key = "user_tower.Dense_0.weight"
    assert not torch.equal(_snapshot(a)["model"][key],
                           _snapshot(c)["model"][key])
