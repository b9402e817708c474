"""The port's training CLI on the CPU: cli/train --train_mode test on
demo_recall records saves a checkpoint; cli/predict and cli/evaluate on that
checkpoint give the trained model's outputs (atol 1e-6: the same model on
the same records) and finite metrics; --lr_schedule trains. --shard_tables
beside --no_mesh raises (the mesh runs: test_torch_dp_trainer.py;
--preempt_dir: test_torch_preempt.py)."""
import os

import numpy as np
import pytest
import torch

import _torch_parity as tp


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from recommendflow_tpu_torch.cli import train as cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import generate_records
    base = tmp_path_factory.mktemp("train_cli")
    generate_records(Configuration(tp.DEMO_CONF), str(base / "rec"),
                     num_rows=1200, num_files=2, seed=5)
    data = os.path.join(str(base / "rec"), "*.rfb")
    result = cli.main([tp.DEMO_CONF, "--data", data, "--train_mode", "test",
                       "--batch_size", "64", "--device", "cpu",
                       "--model_save_root", str(base / "m")])
    return result, data, str(base / "m" / "ckpt" / "final.pt"), base


def test_train_cli_trains_and_saves(trained):
    result, _, final, _ = trained
    hist = result["history"]
    assert len(hist) == 2                          # the config's 2 epochs
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert any(k.startswith("val_hit@") for k in hist[-1])
    assert result["state"].step == 2 * 9           # --train_mode test: <= 10
    assert os.path.isfile(final)


def test_predict_and_evaluate_on_the_trained_checkpoint(trained):
    from recommendflow_tpu_torch.cli import evaluate as eval_cli
    from recommendflow_tpu_torch.cli import predict as pred_cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.pipeline import make_dataset
    from recommendflow_tpu_torch.train.trainer import predict
    result, data, final, base = trained
    out = pred_cli.main([tp.DEMO_CONF, "--data", data, "--checkpoint", final,
                         "--out", str(base / "p"), "--device", "cpu"])
    ds, _ = make_dataset(Configuration(tp.DEMO_CONF), data, 2048,
                         shuffle=False, drop_remainder=False)
    direct = predict(result["state"].model, ds, "cpu")
    for k in ("user", "ad"):
        assert out[k].shape == (1200, 128)
        np.testing.assert_allclose(out[k], direct[k], rtol=0, atol=1e-6)
    metrics = eval_cli.main([tp.DEMO_CONF, "--data", data, "--checkpoint",
                             os.path.dirname(final) + os.sep + "final.pt",
                             "--topk", "5,10", "--device", "cpu"])
    assert metrics and all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("flag", [["--shard_tables", "--no_mesh"]])
def test_flags_of_later_slices_raise(flag):
    """--shard_tables shards over a mesh, which --no_mesh refuses: the
    combination raises before anything is built."""
    from recommendflow_tpu_torch.cli import train as cli
    with pytest.raises(ValueError, match="no_mesh"):
        cli.main([tp.DEMO_CONF, "--device", "cpu", *flag])


def test_train_cli_with_an_lr_schedule(trained, capsys):
    """--lr_schedule cosine --warmup_steps 2 --decay_steps 10 trains on the
    CPU: the dense LR after the last step is the schedule's value at that
    step's count (make_lr_schedule), and ReduceLROnPlateau is left out."""
    from recommendflow_tpu_torch.cli import train as cli
    from recommendflow_tpu_torch.train.optimizers import make_lr_schedule
    from recommendflow_tpu_torch.train.trainer import current_learning_rate
    _, data, _, _ = trained
    result = cli.main([tp.DEMO_CONF, "--data", data, "--train_mode", "test",
                       "--batch_size", "64", "--device", "cpu", "--epochs",
                       "1", "--lr", "0.002", "--lr_schedule", "cosine",
                       "--warmup_steps", "2", "--decay_steps", "10"])
    assert "ReduceLROnPlateau disabled" in capsys.readouterr().out
    state = result["state"]
    assert state.step == 9 and np.isfinite(result["history"][-1]["loss"])
    want = make_lr_schedule(0.002, "cosine", warmup_steps=2, decay_steps=10)
    assert current_learning_rate(state) == want(state.step - 1)


def test_train_cli_defaults_to_the_card(monkeypatch):
    from recommendflow_tpu_torch.cli import train as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([tp.DEMO_CONF, "--data", "/nonexistent/*.rfb"])
