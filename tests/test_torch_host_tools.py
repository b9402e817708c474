"""The port's host tools against the JAX package, on the CPU:

  * `save_variables` / `restore_variables`: a weights-only round trip,
    bitwise (bf16 tables included);
  * `backup_model` on the same directory tree as the JAX function, with
    time.strftime patched: the same day directories kept and the same
    files copied;
  * the streaming AUC (`auc_init` / `auc_update` / `auc_result`) against
    the JAX functions over several batches, within 1e-6 (the same binned
    counts, f32 sums of the same terms in another order), and within 0.01
    of the exact `roc_auc` at 200 thresholds; NaN for one class; an
    `axis_name` without a mesh raises (tests/test_torch_match_axis.py
    holds it over a mesh);
  * `spearman` equal to the JAX function (the same float64 arithmetic),
    ties included;
  * Mmoe's `migrate_legacy_params` on the legacy tree the JAX package's
    tests/test_parallel_misc.py builds: equal to JAX's migration, a
    stacked tree passed through as the same object, and the legacy weights
    loaded through interop (directly and from an .npz) give the flax
    model's outputs within 1e-5.
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop


def test_variables_round_trip(tmp_path):
    from recommendflow_tpu_torch.train.checkpoint import (restore_variables,
                                                          save_variables)
    trainer = tp.demo_trainer({"tower_units": [64, 32],
                               "table_dtype": "bfloat16"})
    model = trainer.model
    path = save_variables(str(tmp_path / "w" / "vars.pt"), model)
    fresh = tp.demo_trainer({"tower_units": [64, 32],
                             "table_dtype": "bfloat16"}).model
    with torch.no_grad():
        for p in fresh.parameters():
            p.add_(1)
    assert restore_variables(path, fresh) is fresh
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    saved = restore_variables(path)
    assert sorted(saved) == sorted(model.state_dict())
    assert saved["embedder.table_dim8"].dtype == torch.bfloat16


def _tree(root):
    out = set()
    for d, _, files in os.walk(root):
        out.update(os.path.relpath(os.path.join(d, f), root) for f in files)
    return out


def test_backup_model_matches_jax(tmp_path, monkeypatch):
    from recommendflow_tpu.train.checkpoint import backup_model as jbackup
    from recommendflow_tpu_torch.train.checkpoint import \
        backup_model as tbackup
    src = tmp_path / "model"
    (src / "ckpt").mkdir(parents=True)
    (src / "ckpt" / "3.pt").write_bytes(b"\x00weights")
    (src / "vocab.txt").write_text("a\nb\n")
    roots = {"jax": tmp_path / "bj", "torch": tmp_path / "bt"}
    for root in roots.values():
        for day in ("20261001", "20261002", "20261005", "notes"):
            (root / day).mkdir(parents=True)
        (root / "20261005" / "stale.txt").write_text("old copy")
    for day in ("20261008", "20261009", "20261010"):
        monkeypatch.setattr(time, "strftime", lambda fmt, day=day: day)
        for name, fn in (("jax", jbackup), ("torch", tbackup)):
            dst = fn(str(src), str(roots[name]), keep_days=3)
            assert dst == str(roots[name] / day)
    for root in roots.values():
        assert sorted(os.listdir(root)) == ["20261008", "20261009",
                                            "20261010", "notes"]
        assert _tree(root / "20261010") == {"ckpt/3.pt", "vocab.txt"}
    assert _tree(roots["jax"]) == _tree(roots["torch"])
    # today's copy is replaced, not merged
    (src / "vocab.txt").unlink()
    for name, fn in (("jax", jbackup), ("torch", tbackup)):
        fn(str(src), str(roots[name]), keep_days=3)
    assert _tree(roots["jax"] / "20261010") == \
        _tree(roots["torch"] / "20261010") == {"ckpt/3.pt"}


def _auc_stream(n_thr=200, n=4000, step=500, seed=0):
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) > 0.5).astype(np.float32)
    score = np.clip(0.5 * y + 0.3 * rng.rand(n), 0, 1).astype(np.float32)
    score[::7] = np.round(score[::7], 2)        # ties, some on thresholds
    return y, score, [(y[i:i + step], score[i:i + step])
                      for i in range(0, n, step)]


@pytest.mark.parametrize("n_thr", [2, 50, 200])
def test_streaming_auc_matches_jax(n_thr):
    from recommendflow_tpu.train import metrics as jm
    from recommendflow_tpu_torch.train import metrics as tm
    y, score, chunks = _auc_stream()
    js, ts = jm.auc_init(n_thr), tm.auc_init(n_thr, device="cpu")
    for yb, sb in chunks:
        js = jm.auc_update(js, jnp.asarray(yb), jnp.asarray(sb[:, None]))
        ts = tm.auc_update(ts, torch.from_numpy(yb),
                           torch.from_numpy(sb[:, None]))
    for field in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)))
    got, want = float(tm.auc_result(ts)), float(jm.auc_result(js))
    assert abs(got - want) <= 1e-6
    if n_thr == 200:
        assert abs(got - tm.roc_auc(y, score)) < 0.01


def test_streaming_auc_one_class_and_axis_name(monkeypatch):
    from recommendflow_tpu_torch.train import metrics as tm
    s = tm.auc_update(tm.auc_init(device="cpu"), torch.ones(8), torch.rand(8))
    assert torch.isnan(tm.auc_result(s))
    with pytest.raises(RuntimeError, match="no mesh"):
        tm.auc_update(tm.auc_init(device="cpu"), torch.ones(8), torch.rand(8),
                      axis_name="dp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.auc_init()                                  # the card by default


@pytest.mark.parametrize("ties", [False, True])
def test_spearman_matches_jax(ties):
    from recommendflow_tpu.train.metrics import spearman as jsp
    from recommendflow_tpu_torch.train.metrics import spearman as tsp
    rng = np.random.RandomState(4)
    a = rng.randn(500)
    b = 0.6 * a + rng.randn(500)
    if ties:
        a, b = np.round(a, 1), np.round(b)
    assert tsp(a, b) == jsp(a, b)
    assert tsp(a, a) == pytest.approx(1.0)
    assert np.isnan(tsp(np.ones(5), a[:5])) and np.isnan(jsp(np.ones(5), a[:5]))


MMOE = "recommendflow_tpu.models.ranking.mmoe.Mmoe"
MMOE_KW = {"num_experts": 3, "num_tasks": 1, "expert_units": (8,),
           "tower_units": (8,), "dropout": 0.0}


@pytest.fixture(scope="module")
def legacy_mmoe():
    """The JAX package's legacy tree (tests/test_parallel_misc.py): an Mmoe
    of 3 experts, its ExpertsMLP_0/experts unstacked into expert{i}."""
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.models.base import build_network
    jc, tc = tp.conf_pair(f"{tp.ROOT}/conf/demo_ranking.yaml")
    model, _ = build_network(MMOE, {"conf": jc, **MMOE_KW})
    batch = synthetic_batch(compile_schema(jc.features), 8, seed=1)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), tp.to_jax(batch), training=False))
    params = dict(variables["params"])
    legacy = dict(params)
    stacked = legacy.pop("ExpertsMLP_0")["experts"]
    for i in range(3):
        legacy[f"expert{i}"] = jax.tree.map(lambda x: x[i], stacked)
    return model, variables, legacy, batch, tc


def test_migration_matches_jax(legacy_mmoe):
    from recommendflow_tpu.models.ranking.mmoe import \
        migrate_legacy_params as jmigrate
    from recommendflow_tpu_torch.models.ranking.mmoe import \
        migrate_legacy_params as tmigrate
    _, variables, legacy, _, _ = legacy_mmoe
    got = interop.flatten(tmigrate(legacy))
    want = interop.flatten(jax.tree.map(np.asarray, jmigrate(legacy)))
    assert sorted(got) == sorted(want) == \
        sorted(interop.flatten(variables["params"]))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    stacked = tmigrate(legacy)
    assert tmigrate(stacked) is stacked
    assert tmigrate(variables["params"]) is variables["params"]


@pytest.mark.parametrize("via_npz", [False, True], ids=["tree", "npz"])
def test_legacy_weights_load_into_the_port(legacy_mmoe, tmp_path, via_npz):
    from recommendflow_tpu_torch.models.base import build_network
    jmodel, variables, legacy, batch, tc = legacy_mmoe
    tree = {**variables, "params": legacy}
    if via_npz:
        tree = interop.load_variables_npz(interop.save_variables_npz(
            str(tmp_path / "legacy.npz"), tree))
    tmodel, _ = build_network(MMOE, {"conf": tc, "device": "cpu", **MMOE_KW})
    interop.load_jax_variables(tmodel, tree)
    want = jmodel.apply(variables, tp.to_jax(batch), training=False)
    with torch.no_grad():
        got = tmodel(tp.to_torch(batch))
    for k in ("score", "score0"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)
