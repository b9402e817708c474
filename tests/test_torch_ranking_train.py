"""Ranking training: the port's Trainer against the JAX trainer on
conf/demo_ranking.yaml at small widths, one case per model.

Both start from the same carried TrainState (the JAX state after one step),
take the same three batches of 64 with dropout 0 on the split path, and are
compared step by step (loss) and at the end (tables, Adagrad accumulators,
dense parameters, Adam moments and count, step), as
tests/test_torch_train.py does for Dssm and with its tolerances: f32 tables
losses rtol 1e-5 and every float leaf atol 1e-5; bf16 tables with
"sparse_set" the tables within 1 bf16 ulp plus atol 1e-4; bf16 tables with
"dense" (the JAX path adds a hot row's duplicate gradients into the bf16
table one by one, the port sums in f32 and rounds once) losses rtol 1e-3,
tables 1 ulp plus atol 0.03, other leaves atol 6e-3. Rows no batch touched
are bit-equal in every case.
"""
import ml_dtypes
import numpy as np
import pytest

import _torch_parity as tp
from recommendflow_tpu_torch import interop
from test_torch_ranking import MODELS, RANK_CONF
from test_torch_train import _tolerances, bf16

# (model, table dtype, split strategy)
CASES = [("dnn", "float32", "sparse_set"), ("dnn", "float32", "dense"),
         ("dcn", "float32", "sparse_set"), ("dcn", "bfloat16", "sparse_set"),
         ("dcn", "bfloat16", "dense"), ("deepfm", "float32", "sparse_set"),
         ("xdeepfm", "float32", "dense"), ("cold", "float32", "sparse_set"),
         ("mmoe", "float32", "sparse_set"), ("essm", "float32", "sparse_set"),
         ("escm2_dr", "float32", "sparse_set"),
         ("escm2_ips", "float32", "dense")]


def _run(name, table_dtype, strategy):
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    from recommendflow_tpu_torch.train.trainer import Trainer
    jc, tc = tp.conf_pair(RANK_CONF, networks={"table_dtype": table_dtype})
    batches = [synthetic_batch(compile_schema(jc.features), 64, seed=60 + i)
               for i in range(4)]
    path, kw = MODELS[name]
    kw = dict(kw, dropout=0.0)
    jmodel, _ = jbuild(path, {"conf": jc, **kw})
    jt = JTrainer(jmodel, learning_rate=1e-3, table_update="split", seed=0)
    js = jt.init_state(jt._put(batches[0]))
    jt._split_dims = {d: strategy for d in jt._split_dims}
    js, _ = jt.train_step(js, batches[0])          # a non-trivial state
    tmodel, _ = tbuild(path, {"conf": tc, "device": "cpu", **kw})
    tt = Trainer(tmodel, learning_rate=1e-3, table_update="split",
                 split_strategy=strategy, device="cpu")
    ts = tt.init_state(batches[0])
    interop.load_train_state(ts, tp.jax_state_tree(js))
    jl, tl = [], []
    for b in batches[1:]:
        js, jm = jt.train_step(js, b)
        ts, tm = tt.train_step(ts, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return (batches, jl, tl, tp.flat_tree(tp.jax_state_tree(js)),
            tp.flat_tree(interop.train_state_tree(ts, ml_dtypes.bfloat16)), tt)


@pytest.mark.parametrize("name,table_dtype,strategy", CASES,
                         ids=["-".join(c) for c in CASES])
def test_three_steps_match_jax(name, table_dtype, strategy):
    from recommendflow_tpu_torch.ops.embedding import touched_stored_rows
    batches, jl, tl, jfin, tfin, tt = _run(name, table_dtype, strategy)
    assert tt._split_dims == {16: strategy}
    loss_rtol, table_atol, atol = _tolerances(table_dtype, strategy)
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    assert sorted(jfin) == sorted(tfin)
    tables = {f"dim{d}": getattr(tt.model.embedder, f"table_dim{d}")
              for d in tt.model.schema.groups}
    touched = set()
    for b in batches[1:]:
        touched.update(touched_stored_rows(tt.model.schema, tables,
                                           tp.to_torch(b))["dim16"].tolist())
    for k, a in jfin.items():
        b = tfin[k]
        if not isinstance(a, np.ndarray):
            assert a == b, k                       # step, Adam count
        elif "table_dim" in k:
            rows = np.ones(a.shape[0], bool)
            rows[sorted(touched)] = False
            bits = tp.bf16_bits if bf16(a) else np.asarray
            np.testing.assert_array_equal(bits(b[rows]), bits(a[rows]), k)
            np.testing.assert_allclose(
                b.astype(np.float32), a.astype(np.float32),
                rtol=2 ** -7 if bf16(a) else 0, atol=table_atol, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=k)
