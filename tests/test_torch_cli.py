"""CPU runs of the port's CLIs on demo_recall records.

cli/predict with a checkpoint written from the JAX side (an npz of the
flattened flax variable tree) gives the JAX model's embeddings to atol 2e-5
(as test_torch_dssm); cli/evaluate on the same checkpoint reports exactly the
metrics the JAX package's retrieval evaluation computes from the port's
predicted vectors."""
import os

import jax
import numpy as np
import pytest

import _torch_parity as tp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from flax.traverse_util import flatten_dict
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.models.base import build_network
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.synthetic import generate_records
    base = tmp_path_factory.mktemp("cli")
    generate_records(Configuration(tp.DEMO_CONF), str(base / "rec"),
                     num_rows=700, num_files=2, seed=4)
    jc, _ = tp.conf_pair()
    model, _ = build_network(jc.networks["class"], {"conf": jc})
    variables = model.init(jax.random.PRNGKey(3), tp.to_jax(
        synthetic_batch(compile_schema(jc.features), 8)), training=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    ckpt = str(base / "vars.npz")
    np.savez(ckpt, **flatten_dict(variables, sep="/"))
    return jc, model, variables, os.path.join(str(base / "rec"), "*.rfb"), ckpt, base


def test_predict_cli_cpu(world):
    from recommendflow_tpu.data.pipeline import make_dataset
    from recommendflow_tpu_torch.cli import predict as cli
    jc, model, variables, data, ckpt, base = world
    out = str(base / "pred")
    got = cli.main([tp.DEMO_CONF, "--data", data, "--checkpoint", ckpt,
                    "--out", out, "--batch_size", "128", "--device", "cpu"])
    saved = np.load(out + ".npz")
    ds, _ = make_dataset(jc, data, 128, shuffle=False, drop_remainder=False)
    ref = {"user": [], "ad": []}
    for b in ds:
        o = model.apply(variables, tp.to_jax(b), training=False)
        for k in ref:
            ref[k].append(np.asarray(o[k]))
    for k in ("user", "ad"):
        r = np.concatenate(ref[k])
        assert saved[k].shape == r.shape == (700, 128)
        np.testing.assert_allclose(saved[k], r, rtol=0, atol=2e-5, err_msg=k)
        np.testing.assert_array_equal(saved[k], got[k])


def test_evaluate_cli_cpu(world):
    from recommendflow_tpu.retrieval import eval as jev
    from recommendflow_tpu.retrieval.flat import TpuSearcher
    from recommendflow_tpu_torch.cli import evaluate as cli
    from recommendflow_tpu_torch.cli import predict as pred_cli
    _, _, _, data, ckpt, base = world
    metrics = cli.main([tp.DEMO_CONF, "--data", data, "--checkpoint", ckpt,
                        "--topk", "5,10,50", "--device", "cpu"])
    out = pred_cli.main([tp.DEMO_CONF, "--data", data, "--checkpoint", ckpt,
                         "--out", str(base / "p2"), "--device", "cpu"])
    corpus, labels, pos = jev.build_eval_corpus(out["user"], out["ad"],
                                                out["label"])
    ks = jev.clamp_topk([5, 10, 50], len(corpus))
    ref = jev.batch_compute_recall_score(
        TpuSearcher(128, metric="cos").train(corpus), out["user"][pos], labels, ks)
    auc = metrics.pop("auc")
    assert metrics == ref
    assert np.isfinite(auc)
