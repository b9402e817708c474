"""Graceful preemption of the port's Trainer.fit and cli/train, on the CPU
(the cases of the JAX package's tests/test_trainer.py preemption tests):
SIGTERM while a batch is drawn finishes the step in flight, writes
`<preempt_dir>/<step>.pt` equal to the returned state and returns without a
validation pass or an epoch-end callback; a fresh Trainer restored from it
finishes at step 12 (2 epochs x 6 batches). Parity: the port preempted and
resumed at dropout 0 against the JAX trainer's uninterrupted fit from the
same carried state (f32 tables: every float leaf within atol 1e-5, the
losses' tolerance of tests/test_torch_train.py; the same f32 arithmetic
summed in another order). cli/train --preempt_dir: the handler installed,
the default directory under --model_save_root, a resume through
--load_checkpoint. Every test puts the process's signal handlers back (the
tier-1 run's xdist workers keep their own).
"""
import os
import signal

import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

NETS = {"tower_units": [64, 32]}
SIGNALS = (signal.SIGTERM, signal.SIGINT)


@pytest.fixture(autouse=True)
def own_handlers():
    saved = {s: signal.getsignal(s) for s in SIGNALS}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


class PoisonedValid:
    def __iter__(self):
        raise AssertionError("validation ran during preemption")

    def __len__(self):
        return 1


class Spy:
    def __init__(self):
        self.epoch_ends, self.train_ends = [], []

    def on_train_begin(self, trainer):
        pass

    def on_epoch_end(self, trainer, state, epoch, logs):
        self.epoch_ends.append(epoch)

    def on_train_end(self, trainer, state, logs):
        self.train_ends.append(state.step)


def _batches(n=6):
    return tp.demo_batches(n, seed=60)


def _port(dropout=0.3, seed=9):
    return tp.demo_trainer(NETS, dropout=dropout, seed=seed)


def test_preemption_checkpoints_and_resumes(tmp_path):
    from recommendflow_tpu_torch.train.checkpoint import (latest_step,
                                                          read_checkpoint,
                                                          restore_checkpoint,
                                                          state_to_host)
    from recommendflow_tpu_torch.train.trainer import \
        install_preemption_handler
    ds = _batches()
    trainer = _port()
    old = install_preemption_handler(trainer)
    assert set(old) == set(SIGNALS)
    assert signal.getsignal(signal.SIGTERM) is not old[signal.SIGTERM]
    pdir = str(tmp_path / "preempt")
    spy = Spy()
    result = trainer.fit(tp.KillAt(ds, 3), epochs=2, valid_ds=PoisonedValid(),
                         callbacks=[spy], preempt_dir=pdir, verbose=False)
    saved = latest_step(pdir)
    # prefetch's thread runs ahead of the steps, so the signal lands after
    # 1 to 4 steps
    assert result["preempted"] and saved is not None and 1 <= saved <= 4
    assert result["state"].step == saved
    assert spy.epoch_ends == [] and spy.train_ends == [saved]
    assert trainer.control["stop"] and "preempt" not in trainer.control
    on_disk = read_checkpoint(pdir)
    live = state_to_host(result["state"])
    for k, v in live["model"].items():
        assert torch.equal(on_disk["model"][k], v), k
    assert on_disk["step"] == saved and on_disk["seed"] == 9

    # a fresh trainer resumes mid-epoch and finishes both epochs
    trainer2 = _port()
    restored = restore_checkpoint(pdir, trainer2.init_state(ds.batches[0]))
    done = trainer2.fit(ds, epochs=2, state=restored, verbose=False)
    assert done["state"].step == 12 and not done["preempted"]
    assert len(done["history"]) == 2 - saved // 6


def test_fit_clears_a_stale_preempt_flag():
    """A flag left from an earlier run does not make fit train zero steps
    (fit clears control['preempt'] at its start)."""
    ds = _batches(2)
    trainer = _port()
    trainer.control["preempt"] = True
    result = trainer.fit(ds, epochs=1, verbose=False)
    assert result["state"].step == 2 and not result["preempted"]


def test_preempted_and_resumed_matches_the_uninterrupted_jax_fit(tmp_path):
    """Both start from the JAX state after one step (carried by interop, so
    the Adam moments, accumulators and BatchNorm statistics are not at
    their initial values), dropout 0, split "sparse_set" on f32 tables; the
    JAX fit runs the remaining 11 steps of 2 epochs x 6 batches without a
    break, the port is preempted, restored and resumed."""
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from recommendflow_tpu_torch.train.checkpoint import restore_checkpoint
    from recommendflow_tpu_torch.train.trainer import \
        install_preemption_handler
    jc, _ = tp.conf_pair(networks=NETS)
    ds = _batches()
    jmodel, _ = jbuild(jc.networks["class"], {"conf": jc, "dropout": 0.0})
    jt = JTrainer(jmodel, learning_rate=1e-3, seed=0)
    js = jt.init_state(jt._put(ds.batches[0]))
    assert jt._split_dims
    jt._split_dims = {d: "sparse_set" for d in jt._split_dims}
    js, _ = jt.train_step(js, ds.batches[0])
    carried = tp.jax_state_tree(js)
    jfin = jt.fit(ds, epochs=2, state=js, verbose=False)["state"]
    assert int(jfin.step) == 12

    def port_from_carried():
        t = _port(dropout=0.0)
        s = t.init_state(ds.batches[0])
        interop.load_train_state(s, carried)
        return t, s

    t1, s1 = port_from_carried()
    install_preemption_handler(t1)
    pdir = str(tmp_path / "p")
    r1 = t1.fit(tp.KillAt(ds, 3), epochs=2, state=s1, preempt_dir=pdir,
                verbose=False)
    assert r1["preempted"] and 1 <= r1["state"].step <= 5
    t2, s2 = port_from_carried()
    restore_checkpoint(pdir, s2)
    tfin = t2.fit(ds, epochs=2, state=s2, verbose=False)["state"]
    assert tfin.step == 12
    want = tp.flat_tree(tp.jax_state_tree(jfin))
    got = tp.flat_tree(interop.train_state_tree(tfin, ml_dtypes.bfloat16))
    assert sorted(want) == sorted(got)
    for k, a in want.items():
        if isinstance(a, np.ndarray) and a.dtype.kind == "f":
            np.testing.assert_allclose(got[k], a, rtol=0, atol=1e-5,
                                       err_msg=k)
        else:
            assert np.array_equal(got[k], a), k


# ------------------------------------------------------------- cli/train
@pytest.fixture(scope="module")
def records(tmp_path_factory):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import generate_records
    base = tmp_path_factory.mktemp("preempt_cli")
    generate_records(Configuration(tp.DEMO_CONF), str(base / "rec"),
                     num_rows=1200, num_files=2, seed=5)
    return os.path.join(str(base / "rec"), "*.rfb")


def _cli_args(records, root, *extra):
    return [tp.DEMO_CONF, "--data", records, "--train_mode", "test",
            "--batch_size", "64", "--device", "cpu", "--model_save_root",
            root, *extra]


def _kill_train_data(monkeypatch, n):
    """cli/train's training split wrapped in tp.KillAt(n)."""
    from recommendflow_tpu_torch.data import pipeline
    real = pipeline.make_dataset

    def make_dataset(*a, **kw):
        train, valid = real(*a, **kw)
        return tp.KillAt(train, n), valid
    monkeypatch.setattr(pipeline, "make_dataset", make_dataset)


def test_train_cli_preempts_into_the_default_dir_and_resumes(
        records, tmp_path, monkeypatch):
    from recommendflow_tpu_torch.cli import train as cli
    from recommendflow_tpu_torch.train.checkpoint import latest_step
    root = str(tmp_path / "m")
    before = signal.getsignal(signal.SIGTERM)
    _kill_train_data(monkeypatch, 3)
    result = cli.main(_cli_args(records, root))
    # the handler stays installed, as the JAX CLI leaves it
    assert signal.getsignal(signal.SIGTERM) is not before
    assert result["preempted"]
    step = latest_step(os.path.join(root, "preempt"))
    assert step == result["state"].step and 1 <= step <= 4
    assert not os.path.exists(os.path.join(root, "ckpt", "final.pt"))
    monkeypatch.undo()
    done = cli.main(_cli_args(records, root, "--load_checkpoint",
                              os.path.join(root, "preempt")))
    assert done["state"].step == 2 * 9 and not done["preempted"]
    assert os.path.isfile(os.path.join(root, "ckpt", "final.pt"))


def test_train_cli_preempt_dir_flag(records, tmp_path, monkeypatch):
    from recommendflow_tpu_torch.cli import train as cli
    from recommendflow_tpu_torch.train.checkpoint import latest_step
    pdir = str(tmp_path / "elsewhere")
    _kill_train_data(monkeypatch, 2)
    result = cli.main(_cli_args(records, str(tmp_path / "m"),
                                "--preempt_dir", pdir))
    assert result["preempted"] and latest_step(pdir) == result["state"].step
    assert not os.path.exists(str(tmp_path / "m" / "preempt"))
