"""SiameseEncoder (conf/demo_text_recall.yaml: one shared 2-layer text
encoder over the bert_encode query and title texts, tokenized on the host
with conf/demo_vocab.txt) through the port's CLIs on the CPU: cli/train
--train_mode test on records from generate_records saves a checkpoint and
reports the recall evaluation; cli/evaluate on it prints recall metrics,
and cli/predict gives the trained model's vectors (atol 1e-6: the same
model on the same records)."""
import os

import numpy as np
import pytest

import _torch_parity as tp

TEXT_CONF = f"{tp.ROOT}/conf/demo_text_recall.yaml"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from recommendflow_tpu_torch.cli import train as cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import generate_records
    base = tmp_path_factory.mktemp("text_cli")
    generate_records(Configuration(TEXT_CONF), str(base / "rec"),
                     num_rows=600, num_files=2, seed=5)
    data = os.path.join(str(base / "rec"), "*.rfb")
    result = cli.main([TEXT_CONF, "--data", data, "--train_mode", "test",
                       "--batch_size", "64", "--device", "cpu",
                       "--topk", "5,10",
                       "--model_save_root", str(base / "m")])
    return result, data, str(base / "m" / "ckpt" / "final.pt"), base


def test_train_cli_on_siamese_encoder(trained):
    from recommendflow_tpu_torch.models.matching import SiameseEncoder
    result, _, final, _ = trained
    hist = result["history"]
    model = result["state"].model
    assert type(model) is SiameseEncoder
    assert model.encoder.num_layers == 2 and model.encoder.model_dim == 64
    assert hist and all(np.isfinite(h["loss"]) for h in hist)
    recall = {k: v for k, v in hist[-1].items() if k.startswith("val_hit@")}
    assert recall and all(0.0 <= v <= 1.0 for v in recall.values())
    assert os.path.isfile(final)
    assert result["state"].table_acc == {}


def test_evaluate_and_predict_on_the_siamese_checkpoint(trained):
    from recommendflow_tpu_torch.cli import evaluate as eval_cli
    from recommendflow_tpu_torch.cli import predict as pred_cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.pipeline import make_dataset
    from recommendflow_tpu_torch.train.trainer import predict
    result, data, final, base = trained
    metrics = eval_cli.main([TEXT_CONF, "--data", data, "--checkpoint", final,
                             "--device", "cpu", "--topk", "5,10"])
    assert metrics and all(np.isfinite(v) for v in metrics.values())
    out = pred_cli.main([TEXT_CONF, "--data", data, "--checkpoint", final,
                         "--out", str(base / "p"), "--device", "cpu"])
    ds, _ = make_dataset(Configuration(TEXT_CONF), data, 2048, shuffle=False,
                         drop_remainder=False)
    direct = predict(result["state"].model, ds, "cpu")
    assert sorted(out) == ["ad", "label", "user"]
    for k in ("user", "ad"):
        assert out[k].shape == (600, 64)
        np.testing.assert_allclose(out[k], direct[k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(out[k], axis=1), 1.0,
                                   atol=1e-5)
