"""A ranking model through the port's CLIs on the CPU: cli/train
--train_mode test on demo_ranking records (Dnn, the config's class) with
--monitor val_auc produces val_auc (the recall evaluator adds nothing for a
scoring model) and saves a checkpoint; cli/evaluate on it returns and prints
the AUC, and cli/predict gives the trained model's scores (atol 1e-6: the
same model on the same records)."""
import os

import numpy as np
import pytest

import _torch_parity as tp

RANK_CONF = f"{tp.ROOT}/conf/demo_ranking.yaml"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from recommendflow_tpu_torch.cli import train as cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import generate_records
    base = tmp_path_factory.mktemp("rank_cli")
    generate_records(Configuration(RANK_CONF), str(base / "rec"),
                     num_rows=1200, num_files=2, seed=6)
    data = os.path.join(str(base / "rec"), "*.rfb")
    result = cli.main([RANK_CONF, "--data", data, "--train_mode", "test",
                       "--batch_size", "64", "--device", "cpu",
                       "--monitor", "val_auc",
                       "--model_save_root", str(base / "m")])
    return result, data, str(base / "m" / "ckpt" / "final.pt"), base


def test_train_cli_on_a_ranking_model(trained):
    from recommendflow_tpu_torch.models.ranking.dnn import Dnn
    result, _, final, _ = trained
    hist = result["history"]
    assert type(result["state"].model) is Dnn
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert 0.0 <= hist[-1]["val_auc"] <= 1.0
    assert not any(k.startswith(("val_hit", "val_mrr")) for k in hist[-1])
    assert os.path.isfile(final)


def test_evaluate_and_predict_on_the_ranking_checkpoint(trained, capsys):
    from recommendflow_tpu_torch.cli import evaluate as eval_cli
    from recommendflow_tpu_torch.cli import predict as pred_cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.pipeline import make_dataset
    from recommendflow_tpu_torch.train.trainer import predict
    result, data, final, base = trained
    metrics = eval_cli.main([RANK_CONF, "--data", data, "--checkpoint", final,
                             "--device", "cpu"])
    assert 0.0 <= metrics["auc"] <= 1.0 and np.isfinite(metrics["aupr"])
    assert f"auc={metrics['auc']:.5f}" in capsys.readouterr().out
    out = pred_cli.main([RANK_CONF, "--data", data, "--checkpoint", final,
                         "--out", str(base / "p"), "--device", "cpu"])
    ds, _ = make_dataset(Configuration(RANK_CONF), data, 2048, shuffle=False,
                         drop_remainder=False)
    direct = predict(result["state"].model, ds, "cpu")
    assert sorted(out) == ["label", "logit", "score"]
    for k in ("score", "logit"):
        assert out[k].shape == (1200,)
        np.testing.assert_allclose(out[k], direct[k], rtol=0, atol=1e-6)
