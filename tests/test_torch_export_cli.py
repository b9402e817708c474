"""Export and serving through the port's CLIs on the CPU (Dnn, the class of
conf/demo_ranking.yaml): cli/train --train_mode test saves a checkpoint,
cli/export writes an .rfx from it (labels baked in as zeroed constants,
reloaded and run once), cli/serve --model serves it, and /predict on rows
of the records gives cli/predict's scores for the same rows (within 1e-5,
the chip script's CLI rule; 0 expected: the same model and ops)."""
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

import _torch_parity as tp

RANK_CONF = f"{tp.ROOT}/conf/demo_ranking.yaml"
BATCH = 32


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    from recommendflow_tpu_torch.cli import export as export_cli
    from recommendflow_tpu_torch.cli import train as train_cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import generate_records
    base = tmp_path_factory.mktemp("export_cli")
    generate_records(Configuration(RANK_CONF), str(base / "rec"),
                     num_rows=600, num_files=2, seed=8)
    data = os.path.join(str(base / "rec"), "*.rfb")
    train_cli.main([RANK_CONF, "--data", data, "--train_mode", "test",
                    "--batch_size", "64", "--device", "cpu",
                    "--monitor", "val_auc", "--model_save_root",
                    str(base / "m")])
    final = str(base / "m" / "ckpt" / "final.pt")
    path = export_cli.main([RANK_CONF, "--checkpoint", final, "--out",
                            str(base / "model"), "--batch_size", str(BATCH),
                            "--device", "cpu"])
    return path, data, final, base


def test_export_cli_writes_the_trained_model(exported, capsys):
    import torch
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.export import ServingModel, custom_op_nodes
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.checkpoint import read_checkpoint
    path, _, final, _ = exported
    assert path.endswith("model.rfx") and os.path.isfile(path)
    serving = ServingModel.load(path, device="cpu")
    conf = Configuration(RANK_CONF)
    labels = ["click", "conversion"]
    assert not set(serving.batch_keys) & set(labels)
    assert all(shape[0] == BATCH for shape in serving.meta["shapes"].values())
    assert custom_op_nodes(serving.program) == {"recflow::gather_rows": 1}
    # the checkpoint's weights, not the random ones
    model, _ = build_network(conf.networks["class"],
                             {"conf": conf, "device": "cpu", "seed": 0})
    model.load_state_dict(read_checkpoint(final)["model"])
    batch = synthetic_batch(model.schema, BATCH, seed=3)
    with torch.no_grad():
        want = model.eval()(tp.to_torch(
            {**batch, **{k: np.zeros_like(batch[k]) for k in labels}}))
    got = serving.predict({k: v for k, v in batch.items() if k not in labels})
    np.testing.assert_array_equal(got["score"], want["score"].numpy())


def test_serve_cli_predict_equals_predict_cli(exported):
    from recommendflow_tpu_torch.cli import predict as pred_cli
    from recommendflow_tpu_torch.cli import serve as serve_cli
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.pipeline import make_dataset
    path, data, final, base = exported
    want = pred_cli.main([RANK_CONF, "--data", data, "--checkpoint", final,
                          "--out", str(base / "p"), "--device", "cpu"])
    ds, _ = make_dataset(Configuration(RANK_CONF), data, BATCH, shuffle=False,
                         valid_ratio=0.0, drop_remainder=False)
    rows = next(iter(ds))
    backend, httpd = serve_cli.build(["--model", path, "--host", "127.0.0.1",
                                      "--port", "0", "--device", "cpu"])
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        body = json.dumps({"batch": {k: np.asarray(v).tolist()
                                     for k, v in rows.items()}}).encode()
        req = urllib.request.Request(url + "/predict", data=body,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        backend.close()
    score = np.asarray(out["score"], np.float32)
    assert score.shape == (BATCH,)
    np.testing.assert_allclose(score, want["score"][:BATCH], rtol=0, atol=1e-5)


def test_export_cli_refuses_the_tensorflow_formats(tmp_path):
    from recommendflow_tpu_torch.cli import export as export_cli
    for fmt in ("savedmodel", "both"):
        with pytest.raises(NotImplementedError, match="TensorFlow"):
            export_cli.main([RANK_CONF, "--out", str(tmp_path / "m"),
                             "--format", fmt, "--device", "cpu"])


def test_export_cli_without_a_checkpoint_warns_and_raises_without_a_card(
        tmp_path, capsys, monkeypatch):
    from recommendflow_tpu_torch.cli import export as export_cli
    path = export_cli.main([RANK_CONF, "--out", str(tmp_path / "m"),
                            "--batch_size", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "RANDOMLY INITIALIZED" in out and "reload check" in out
    assert os.path.isfile(path)
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_cli.main([RANK_CONF, "--out", str(tmp_path / "m2")])
