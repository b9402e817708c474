"""The port's fit() machinery on the CPU: callbacks, checkpoints and the
epoch-end evaluations.

* EarlyStopping stops after `patience` epochs without improvement and
  restores the best epoch's state (with the LR it had, as the JAX state
  carries its injected LR); ReduceLROnPlateau scales the dense LR;
  ModelCheckpoint writes per-epoch and best files.
* A saved checkpoint restores the whole training state bitwise, and
  training resumed from it takes the same steps as an uninterrupted run
  (bitwise: the same CPU arithmetic in the same order).
* make_recall_evaluator and Trainer.evaluate report what the JAX package's
  make_recall_evaluator and Trainer.evaluate report for the same model
  outputs and the same carried state (recall metrics equal, val_loss rtol
  1e-5, val_auc equal to 1e-6).
"""
import os

import numpy as np
import torch

import _torch_parity as tp


def _setup(seed=0, n_batches=4, dropout=0.0):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.train.trainer import Trainer
    conf = Configuration(tp.DEMO_CONF)
    conf.networks["tower_units"] = [32]
    model = Dssm(conf, device="cpu", dropout=dropout, seed=seed)
    batches = [synthetic_batch(model.schema, 32, seed=100 + i)
               for i in range(n_batches)]
    return Trainer(model, device="cpu"), batches


def _snapshot(state):
    from recommendflow_tpu_torch.train.checkpoint import state_to_host
    return state_to_host(state)


def _assert_same(a, b):
    assert a["step"] == b["step"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for k, v in a["table_acc"].items():
        assert torch.equal(v, b["table_acc"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)


def test_early_stopping_restores_the_best_epoch_and_plateau_scales_lr():
    from recommendflow_tpu_torch.train.callbacks import (Callback,
                                                         EarlyStopping,
                                                         ReduceLROnPlateau)
    trainer, batches = _setup()
    scores = iter([0.5, 0.7, 0.6, 0.65, 0.4, 0.3])
    snaps = []

    class Score(Callback):
        def on_epoch_end(self, trainer, state, epoch, logs):
            logs["val_hit@5"] = next(scores)
            snaps.append(_snapshot(state))

    es = EarlyStopping(monitor="val_hit@5", patience=2)
    plateau = ReduceLROnPlateau(monitor="val_hit@5", patience=1, factor=0.5)
    res = trainer.fit(batches, epochs=6, callbacks=[Score(), es, plateau],
                      verbose=False)
    assert len(res["history"]) == 4               # stopped after epoch 3
    assert trainer.control["stop"] is True
    _assert_same(_snapshot(res["state"]), snaps[1])   # the best: 0.7
    # plateaus after epochs 2 and 3 (patience 1); epoch 3 ran at half the
    # LR, and the restored epoch-1 state carries its own LR back
    assert trainer.control["lr_scale"] == 0.25
    assert snaps[3]["optimizer"]["param_groups"][0]["lr"] == trainer.base_lr * 0.5
    lrs = [g["lr"] for g in res["state"].optimizer.param_groups]
    assert lrs == [trainer.base_lr]


def test_model_checkpoint_and_resume_are_exact(tmp_path):
    from recommendflow_tpu_torch.train.callbacks import (Callback,
                                                         ModelCheckpoint)
    from recommendflow_tpu_torch.train.checkpoint import (latest_step,
                                                          read_checkpoint,
                                                          restore_checkpoint)

    class Loss(Callback):
        def on_epoch_end(self, trainer, state, epoch, logs):
            logs["val_loss"] = [3.0, 2.0, 2.5][epoch]

    root = str(tmp_path / "ckpt")
    trainer, batches = _setup()
    full = trainer.fit(batches, epochs=3, callbacks=[
        Loss(), ModelCheckpoint(root, keep=2, monitor="val_loss")],
        verbose=False)["state"]
    assert sorted(os.listdir(root)) == ["1.pt", "2.pt", "best.pt"]
    assert latest_step(root) == 2
    assert read_checkpoint(os.path.join(root, "best.pt"))["step"] == 8
    _assert_same(read_checkpoint(root), _snapshot(full))

    # resume from the epoch-1 checkpoint: one more epoch reproduces epoch 3
    trainer2, _ = _setup(seed=9)                  # other initial weights
    state = trainer2.init_state(batches[0])
    restore_checkpoint(root, state, step=1)
    assert state.step == 8
    resumed = trainer2.fit(batches, epochs=3, state=state, verbose=False)
    assert len(resumed["history"]) == 1
    _assert_same(_snapshot(resumed["state"]), _snapshot(full))


def test_recall_evaluator_and_evaluate_match_jax():
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.retrieval.eval import make_recall_evaluator as jmake
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from recommendflow_tpu_torch import interop
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    from recommendflow_tpu_torch.retrieval.eval import make_recall_evaluator
    from recommendflow_tpu_torch.train.trainer import Trainer
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    jc, tc = tp.conf_pair(networks={"tower_units": [32]})
    batches = [synthetic_batch(compile_schema(jc.features), 64, seed=7 + i)
               for i in range(3)]
    jmodel, _ = jbuild(jc.networks["class"], {"conf": jc, "dropout": 0.0})
    jt = JTrainer(jmodel, table_update="split", seed=0)
    js = jt.init_state(jt._put(batches[0]))
    js, _ = jt.train_step(js, batches[0])
    tmodel, _ = tbuild(tc.networks["class"], {"conf": tc, "dropout": 0.0,
                                              "device": "cpu"})
    tt = Trainer(tmodel, table_update="split", device="cpu")
    ts = tt.init_state(batches[0])
    interop.load_train_state(ts, tp.jax_state_tree(js))
    jlogs = jt.evaluate(js, batches)
    tlogs = tt.evaluate(ts, batches)
    assert sorted(jlogs) == sorted(tlogs) == ["val_auc", "val_loss"]
    np.testing.assert_allclose(tlogs["val_loss"], jlogs["val_loss"], rtol=1e-5)
    np.testing.assert_allclose(tlogs["val_auc"], jlogs["val_auc"], atol=1e-6)
    # the recall evaluator on the same predicted vectors
    out = tt.predict(ts, batches)

    class Fixed:
        device = torch.device("cpu")

        def predict(self, state, dataset):
            return out
    got = make_recall_evaluator(batches, topk_list=[5, 10, 50])(Fixed(), None)
    want = jmake(batches, topk_list=[5, 10, 50])(Fixed(), None)
    assert got == want
    assert got["val_num_items"] > 0 and "val_hit@50" in got
