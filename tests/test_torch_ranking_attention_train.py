"""Training the ranking models with attention: the port's Trainer against
the JAX trainer, three carried split steps per case (Din on
conf/demo_din.yaml, TabTransformer and Esim on conf/demo_ranking.yaml, at
test_torch_ranking_attention.py's widths, dropout 0).

Both start from the same carried TrainState (the JAX state after one step,
Dice's running statistics included), take the same three batches of 64 and
are compared step by step (loss) and at the end (tables, Adagrad
accumulators, dense parameters, Dice's statistics, Adam moments and count,
step) with tests/test_torch_train.py's tolerances: f32 tables losses rtol
1e-5 and every float leaf atol 1e-5; bf16 tables with "sparse_set" the
tables within 1 bf16 ulp plus atol 1e-4. Rows no batch touched are
bit-equal.

The bf16 case carries the JAX state into the port again before each of its
three steps and holds every step's result: TabTransformer's post-LN blocks
normalise 16-wide field embeddings of ~0.03 spread, so a bf16 table element
that rounded the other way in one step (a 1-ulp difference, which the
tolerance allows) moves the next step's row gradients by ~10 bf16 ulps
(4.7e-3 of 0.105 at the largest, from 12 such elements after two steps),
and then a row's Adagrad update moves by more than an ulp. From one carried
state the port's bf16 step equals the JAX step bit for bit in the table.

One leaf kind is held otherwise: an attention block's key bias
(`.../mha/k/bias`). Its gradient is 0 in exact arithmetic (it adds q·b to
every score of a query's row, and softmax ignores a shift of the whole row),
so both sides' gradients are summation noise (~1e-9 here) and Adam, which
divides a gradient by its own magnitude, moves the bias by noise of up to
Adam's step, lr·(1-β1)/√(1-β2) ≈ 3.2·lr, each step. There the gradient must
be noise on both sides (below 1e-6) and the bias within three such steps.
"""
import ml_dtypes
import numpy as np
import pytest

import _torch_parity as tp
from recommendflow_tpu_torch import interop
from test_torch_ranking_attention import MODELS, model_batch
from test_torch_train import _tolerances, bf16

LR = 1e-3
ADAM_STEP = LR * (1 - 0.9) / np.sqrt(1 - 0.999)
# (model, table dtype, split strategy)
CASES = [("din", "float32", "sparse_set"), ("din", "float32", "dense"),
         ("tabtransformer", "float32", "sparse_set"),
         ("tabtransformer", "float32", "dense"),
         ("tabtransformer", "bfloat16", "sparse_set"),
         ("esim", "float32", "sparse_set"), ("esim", "float32", "dense")]


def _run(name, table_dtype, strategy):
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from recommendflow_tpu_torch.models.base import build_network as tbuild
    from recommendflow_tpu_torch.train.trainer import Trainer
    batches = [model_batch(name, table_dtype, b=64, seed=60 + i)
               for i in range(4)]
    jc, tc = batches[0][:2]
    batches = [b for _, _, b in batches]
    _, path, kw = MODELS[name]
    kw = dict(kw, dropout=0.0)
    jmodel, _ = jbuild(path, {"conf": jc, **kw})
    jt = JTrainer(jmodel, learning_rate=LR, table_update="split", seed=0)
    js = jt.init_state(jt._put(batches[0]))
    jt._split_dims = {d: strategy for d in jt._split_dims}
    js, _ = jt.train_step(js, batches[0])          # a non-trivial state
    tmodel, _ = tbuild(path, {"conf": tc, "device": "cpu", **kw})
    tt = Trainer(tmodel, learning_rate=LR, table_update="split",
                 split_strategy=strategy, device="cpu")
    ts = tt.init_state(batches[0])
    interop.load_train_state(ts, tp.jax_state_tree(js))
    recarry = table_dtype == "bfloat16"
    jl, tl, k_bias_grads, states = [], [], [], []
    for b in batches[1:]:
        if recarry:
            interop.load_train_state(ts, tp.jax_state_tree(js))
        js, jm = jt.train_step(js, b)
        ts, tm = tt.train_step(ts, b)
        k_bias_grads.extend(float(p.grad.abs().max()) for n, p in
                            tmodel.named_parameters() if n.endswith("k.bias"))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        if recarry or len(jl) == 3:
            states.append((tp.flat_tree(tp.jax_state_tree(js)), tp.flat_tree(
                interop.train_state_tree(ts, ml_dtypes.bfloat16))))
    return batches, jl, tl, states, tt, k_bias_grads


@pytest.mark.parametrize("name,table_dtype,strategy", CASES,
                         ids=["-".join(c) for c in CASES])
def test_three_steps_match_jax(name, table_dtype, strategy):
    from recommendflow_tpu_torch.ops.embedding import touched_stored_rows
    batches, jl, tl, states, tt, k_bias_grads = _run(name, table_dtype,
                                                     strategy)
    dims = sorted(tt.model.schema.groups)
    assert tt._split_dims == {d: strategy for d in dims}
    loss_rtol, table_atol, atol = _tolerances(table_dtype, strategy)
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    tables = {f"dim{d}": getattr(tt.model.embedder, f"table_dim{d}")
              for d in dims}
    touched = {k: set() for k in tables}
    for b in batches[1:]:
        for k, rows in touched_stored_rows(tt.model.schema, tables,
                                           tp.to_torch(b)).items():
            touched[k].update(rows.tolist())
    assert len(states) == (3 if table_dtype == "bfloat16" else 1)
    for jfin, tfin in states:
        assert sorted(jfin) == sorted(tfin)
        if name == "din":
            assert any("dice0/BatchNorm_0/mean" in k for k in tfin)
        for k, a in jfin.items():
            b = tfin[k]
            if not isinstance(a, np.ndarray):
                assert a == b, k                       # step, Adam count
            elif "table_dim" in k:
                rows = np.ones(a.shape[0], bool)
                rows[sorted(touched[k.split("table_")[-1]])] = False
                bits = tp.bf16_bits if bf16(a) else np.asarray
                np.testing.assert_array_equal(bits(b[rows]), bits(a[rows]), k)
                np.testing.assert_allclose(
                    b.astype(np.float32), a.astype(np.float32),
                    rtol=2 ** -7 if bf16(a) else 0, atol=table_atol,
                    err_msg=k)
            elif k.startswith("params/") and k.endswith("mha/k/bias"):
                np.testing.assert_allclose(b, a, rtol=0, atol=3 * ADAM_STEP,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=k)
    assert (len(k_bias_grads) > 0) == (name != "din")
    assert max(k_bias_grads, default=0.0) < 1e-6


def test_train_state_tree_copies_bf16_leaves():
    """The tree read off a state holds copies: a later in-place step does not
    change it (a bf16 leaf once came out as a view of the table)."""
    from recommendflow_tpu_torch.interop import to_numpy
    import torch
    t = torch.zeros(4, dtype=torch.bfloat16)
    a = to_numpy(t, ml_dtypes.bfloat16)
    t += 1
    assert not a.astype(np.float32).any()
