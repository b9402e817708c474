"""The port's cli/finetune on the CPU (the counterpart of the JAX package's
tests/test_cli_e2e.py train -> finetune path), on demo_recall records with
--device cpu:

  * cli/train writes a checkpoint; cli/finetune restores it, and its
    pre-finetune metrics (the recall evaluation plus Trainer.evaluate, in
    eval mode, so dropout does not enter) equal the JAX cli/finetune's
    base_logs within 1e-5 when both start from the same weights (a JAX
    TrainState carried into the port by interop; f32 sums in another
    order);
  * --lr replaces the checkpoint's learning rate;
  * the promotion constraints pass and promote to
    `<model_save_root>/online` (cli/predict reads it: the finetuned
    model's outputs within 1e-6), or block with PromotionBlocked and write
    no `online`;
  * --train_mode test never promotes.
"""
import os

import numpy as np
import pytest

import _torch_parity as tp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from recommendflow_tpu_torch.cli import train as train_cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import generate_records
    base = tmp_path_factory.mktemp("finetune_cli")
    generate_records(Configuration(tp.DEMO_CONF), str(base / "rec"),
                     num_rows=1200, num_files=2, seed=7)
    data = os.path.join(str(base / "rec"), "*.rfb")
    train_cli.main([tp.DEMO_CONF, "--data", data, "--train_mode", "test",
                    "--batch_size", "64", "--epochs", "1", "--device", "cpu",
                    "--model_save_root", str(base / "run")])
    return data, str(base / "run" / "ckpt" / "final.pt")


def _finetune(data, ckpt, root, *extra):
    from recommendflow_tpu_torch.cli import finetune
    return finetune.main([tp.DEMO_CONF, "--data", data, "--load_checkpoint",
                          ckpt, "--model_save_root", root, "--batch_size",
                          "64", "--epochs", "1", "--device", "cpu", *extra])


def test_finetune_promotes_and_predict_reads_online(world, tmp_path, capsys):
    from recommendflow_tpu_torch.cli import predict as pred_cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.pipeline import make_dataset
    from recommendflow_tpu_torch.train.trainer import predict
    data, ckpt = world
    root = str(tmp_path / "ft")
    os.makedirs(os.path.join(root, "online"))
    with open(os.path.join(root, "online", "999.pt"), "wb") as f:
        f.write(b"an older promotion")
    out = _finetune(data, ckpt, root, "--lr", "5e-4",
                    "--promotion_constraints", "val_hit@10=[-1, inf)")
    assert "pre-finetune metrics" in capsys.readouterr().out
    step = out["state"].step
    assert out["online"] == os.path.join(root, "online", f"{step}.pt")
    assert os.listdir(os.path.join(root, "online")) == [f"{step}.pt"]
    assert os.path.isdir(os.path.join(root, "ckpt"))    # per-epoch saves
    assert "val_hit@10" in out["base_logs"] and "val_auc" in out["final_logs"]
    got = pred_cli.main([tp.DEMO_CONF, "--data", data, "--checkpoint",
                         os.path.join(root, "online"), "--out",
                         str(tmp_path / "p"), "--device", "cpu"])
    ds, _ = make_dataset(Configuration(tp.DEMO_CONF), data, 2048,
                         shuffle=False, drop_remainder=False)
    want = predict(out["state"].model, ds, "cpu")
    for k in ("user", "ad"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_a_constraint_that_cannot_hold_blocks(world, tmp_path):
    from recommendflow_tpu_torch.train.monitor import PromotionBlocked
    data, ckpt = world
    root = str(tmp_path / "ft")
    # a relative change below -1 needs a negative hit rate
    with pytest.raises(PromotionBlocked, match="val_hit@10"):
        _finetune(data, ckpt, root, "--promotion_constraints",
                  "val_hit@10=(-inf, -1)")
    assert not os.path.exists(os.path.join(root, "online"))


def test_test_mode_never_promotes(world, tmp_path, capsys):
    data, ckpt = world
    root = str(tmp_path / "ft")
    out = _finetune(data, ckpt, root, "--train_mode", "test",
                    "--promotion_constraints", "val_auc=[-1, inf)")
    assert out["online"] is None and "NOT promoting" in capsys.readouterr().out
    assert not os.path.exists(root)


def test_lr_overrides_the_checkpoint_lr(world, tmp_path):
    """The checkpoint carries a plateau-reduced LR (1e-5); restoring brings
    it back (the hazard), and --lr 5e-4 wins in cli/finetune."""
    from recommendflow_tpu_torch.train.checkpoint import (read_checkpoint,
                                                          restore_checkpoint,
                                                          save_checkpoint)
    from recommendflow_tpu_torch.train.trainer import current_learning_rate
    data, ckpt = world
    trainer = tp.demo_trainer({}, split_strategy="auto")
    state = trainer.init_state(tp.demo_batches(1, seed=3).batches[0])
    restore_checkpoint(ckpt, state)
    trainer.set_learning_rate(state, 1e-5)
    low = save_checkpoint(str(tmp_path / "low.pt"), state)
    assert read_checkpoint(low)["optimizer"]["param_groups"][0]["lr"] == 1e-5
    again = tp.demo_trainer({}, split_strategy="auto")
    s2 = restore_checkpoint(low, again.init_state(
        tp.demo_batches(1, seed=3).batches[0]))
    assert current_learning_rate(s2) == 1e-5
    out = _finetune(data, low, str(tmp_path / "ft"), "--train_mode", "test",
                    "--lr", "5e-4")
    assert current_learning_rate(out["state"]) == 5e-4
    assert out["state"].step > state.step


def test_base_logs_match_the_jax_finetune(world, tmp_path, monkeypatch):
    """The JAX cli/finetune's base_logs (read where it hands them to the
    promotion gate) against the port's, from the same weights."""
    from recommendflow_tpu.cli import finetune as jfinetune
    from recommendflow_tpu.config import Configuration as JConf
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.train import monitor as jmonitor
    from recommendflow_tpu.train.checkpoint import \
        save_checkpoint as jsave
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from recommendflow_tpu_torch import interop
    from recommendflow_tpu_torch.train.checkpoint import save_checkpoint
    data, _ = world
    jconf = JConf(tp.DEMO_CONF)
    jmodel, _ = jbuild(jconf.networks["class"], {"conf": jconf})
    jt = JTrainer(jmodel, learning_rate=1e-3, seed=0)
    batch = tp.demo_batches(1, seed=3).batches[0]
    js = jt.init_state(jt._put(batch))
    js, _ = jt.train_step(js, batch)
    jroot = str(tmp_path / "jckpt")
    jsave(jroot, js, step=0)
    trainer = tp.demo_trainer({}, split_strategy="auto")
    ts = trainer.init_state(batch)
    interop.load_train_state(ts, tp.jax_state_tree(js))
    tckpt = save_checkpoint(str(tmp_path / "t.pt"), ts)

    seen = {}

    def capture(base, final, constraints, alert=None):
        seen["base"] = dict(base)
        return {}
    monkeypatch.setattr(jmonitor, "model_online_monitor", capture)
    common = ["--data", data, "--model_save_root", str(tmp_path / "jft"),
              "--train_mode", "test", "--batch_size", "64",
              "--promotion_constraints", "val_auc=[-1, inf)"]
    jfinetune.main([tp.DEMO_CONF, "--load_checkpoint", jroot, *common])
    out = _finetune(data, tckpt, str(tmp_path / "tft"), "--train_mode",
                    "test", "--promotion_constraints", "val_auc=[-1, inf)")
    want, got = seen["base"], out["base_logs"]
    assert sorted(got) == sorted(want) and "val_auc" in got
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
