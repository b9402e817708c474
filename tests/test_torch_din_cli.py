"""Din (conf/demo_din.yaml) through the port's CLIs on the CPU: cli/train
--train_mode test --monitor val_auc on records from generate_records saves a
checkpoint and reports val_auc; cli/evaluate on it prints the AUC, and
cli/predict gives the trained model's scores (atol 1e-6: the same model on
the same records)."""
import os

import numpy as np
import pytest

import _torch_parity as tp

DIN_CONF = f"{tp.ROOT}/conf/demo_din.yaml"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from recommendflow_tpu_torch.cli import train as cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import generate_records
    base = tmp_path_factory.mktemp("din_cli")
    generate_records(Configuration(DIN_CONF), str(base / "rec"),
                     num_rows=1200, num_files=2, seed=8)
    data = os.path.join(str(base / "rec"), "*.rfb")
    result = cli.main([DIN_CONF, "--data", data, "--train_mode", "test",
                       "--batch_size", "64", "--device", "cpu",
                       "--monitor", "val_auc",
                       "--model_save_root", str(base / "m")])
    return result, data, str(base / "m" / "ckpt" / "final.pt"), base


def test_train_cli_on_din(trained):
    from recommendflow_tpu_torch.models.ranking.din import Din
    result, _, final, _ = trained
    hist = result["history"]
    model = result["state"].model
    assert type(model) is Din
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert 0.0 <= hist[-1]["val_auc"] <= 1.0
    assert os.path.isfile(final)
    # Dice's running statistics moved off their init in training
    assert float(model.dice0.BatchNorm_0.running_var.sub(1).abs().max()) > 0


def test_evaluate_and_predict_on_the_din_checkpoint(trained, capsys):
    from recommendflow_tpu_torch.cli import evaluate as eval_cli
    from recommendflow_tpu_torch.cli import predict as pred_cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.pipeline import make_dataset
    from recommendflow_tpu_torch.train.trainer import predict
    result, data, final, base = trained
    metrics = eval_cli.main([DIN_CONF, "--data", data, "--checkpoint", final,
                             "--device", "cpu"])
    assert 0.0 <= metrics["auc"] <= 1.0 and np.isfinite(metrics["aupr"])
    assert f"auc={metrics['auc']:.5f}" in capsys.readouterr().out
    out = pred_cli.main([DIN_CONF, "--data", data, "--checkpoint", final,
                         "--out", str(base / "p"), "--device", "cpu"])
    ds, _ = make_dataset(Configuration(DIN_CONF), data, 2048, shuffle=False,
                         drop_remainder=False)
    direct = predict(result["state"].model, ds, "cpu")
    assert sorted(out) == ["label", "logit", "score"]
    for k in ("score", "logit"):
        assert out[k].shape == (1200,)
        np.testing.assert_allclose(out[k], direct[k], rtol=0, atol=1e-6)
