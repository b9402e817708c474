"""Dssm training: the port's Trainer against the JAX trainer.

Both start from the same carried TrainState (the JAX state after one step,
so the Adam moments, accumulators and BatchNorm statistics are not at their
initial values), take the same three demo_recall batches of 64 with dropout
0, and are compared step by step (loss) and at the end (tables, Adagrad
accumulators, dense parameters, Adam moments and count, BatchNorm running
statistics, step), for the split path with the "dense" and "sparse_set"
strategies and for table_update="dense". Rows no batch touched are
bit-equal in every case. Tolerances (measured worst case in brackets):

  * f32 tables, every mode: losses rtol 1e-5; every float leaf atol 1e-5
    [4e-7]: the same f32 arithmetic, summed in another order.
  * bf16 tables, split "sparse_set": the same, and the tables within 1 bf16
    ulp (rtol 2^-7) plus atol 1e-4 [4e-5]: a 1-ulp difference from a
    rounding tie moves the next steps a little.
  * bf16 tables, split "dense" and table_update="dense": losses rtol 1e-3
    [1.2e-4]; tables within 1 ulp plus atol 0.03 [0.009, of updates up to
    0.095]; the other float leaves atol 6e-3 [1.8e-3, Adam's first moment].
    The JAX paths add a hot row's duplicate gradients (a categorical id
    occurs ~32 times in a batch) into the bf16 table one by one, rounding
    after each add, and the optax row-wise Adagrad rounds its update before
    the add; the port sums in f32 and rounds once (train/optimizers.py).
    tests/test_torch_optimizers.py holds the one-step updates to tighter
    bounds.
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

NETS = {"tower_units": [64, 32]}
MODES = [("split", "dense"), ("split", "sparse_set"), ("dense", "dense")]


def _world(table_dtype):
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    jc, tc = tp.conf_pair(networks=dict(NETS, table_dtype=table_dtype))
    batches = [synthetic_batch(compile_schema(jc.features), 64, seed=40 + i)
               for i in range(4)]
    return jc, tc, batches


def _jax_trainer(jc, mode, strategy, batches):
    from recommendflow_tpu.models.base import build_network
    from recommendflow_tpu.train.trainer import Trainer
    model, _ = build_network(jc.networks["class"], {"conf": jc, "dropout": 0.0})
    t = Trainer(model, learning_rate=1e-3, table_update=mode, seed=0)
    state = t.init_state(t._put(batches[0]))
    if mode == "split":
        assert t._split_dims
        t._split_dims = {d: strategy for d in t._split_dims}
    return t, state


def _port_trainer(tc, mode, strategy, batches):
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer
    model, _ = build_network(tc.networks["class"],
                             {"conf": tc, "dropout": 0.0, "device": "cpu"})
    t = Trainer(model, learning_rate=1e-3, table_update=mode,
                split_strategy=strategy, device="cpu")
    return t, t.init_state(batches[0])


def _run(table_dtype, mode, strategy):
    jc, tc, batches = _world(table_dtype)
    jt, js = _jax_trainer(jc, mode, strategy, batches)
    js, _ = jt.train_step(js, batches[0])            # non-trivial state
    tt, ts = _port_trainer(tc, mode, strategy, batches)
    interop.load_train_state(ts, tp.jax_state_tree(js))
    start = tp.flat_tree(tp.jax_state_tree(js))
    jl, tl = [], []
    for b in batches[1:]:
        js, jm = jt.train_step(js, b)
        ts, tm = tt.train_step(ts, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return (start, jl, tl, tp.flat_tree(tp.jax_state_tree(js)),
            tp.flat_tree(interop.train_state_tree(ts, ml_dtypes.bfloat16)), tt)


def _tolerances(table_dtype, strategy):
    """(loss rtol, table atol, other float leaves atol); see the module
    docstring."""
    if table_dtype == "float32":
        return 1e-5, 1e-5, 1e-5
    if strategy == "sparse_set":
        return 1e-5, 1e-4, 1e-5
    return 1e-3, 0.03, 6e-3


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,strategy", MODES,
                         ids=["split-dense", "split-sparse_set", "dense"])
def test_three_steps_match_jax(table_dtype, mode, strategy):
    from recommendflow_tpu_torch.ops.embedding import touched_stored_rows
    start, jl, tl, jfin, tfin, tt = _run(table_dtype, mode, strategy)
    if mode == "split":
        assert set(tt._split_dims.values()) == {strategy}
    loss_rtol, table_atol, atol = _tolerances(table_dtype, strategy)
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    assert sorted(jfin) == sorted(tfin)
    tables = {f"dim{d}": getattr(tt.model.embedder, f"table_dim{d}")
              for d in tt.model.schema.groups}
    touched = {}
    for b in _world(table_dtype)[2][1:]:
        for k, r in touched_stored_rows(tt.model.schema, tables,
                                        tp.to_torch(b)).items():
            touched.setdefault(k, set()).update(r.tolist())
    for k, a in jfin.items():
        b = tfin[k]
        if not isinstance(a, np.ndarray):
            assert a == b, k                       # step, Adam count
            continue
        if "table_dim" in k:
            rows = np.ones(a.shape[0], bool)
            rows[sorted(touched[k.split("table_")[-1]])] = False
            bits = tp.bf16_bits if bf16(a) else np.asarray
            np.testing.assert_array_equal(bits(b[rows]), bits(a[rows]), k)
            a32, b32 = a.astype(np.float32), b.astype(np.float32)
            np.testing.assert_allclose(b32, a32, rtol=2 ** -7 if bf16(a) else 0,
                                       atol=table_atol, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=k)
    # the steps did move every kind of state
    for k in ("table_acc/dim16", "batch_stats/user_tower/BatchNorm_0/var",
              "params/embedder/table_dim16", "opt/mu/ad_tower/Dense_0/kernel"):
        assert not np.array_equal(np.asarray(start[k], np.float32),
                                  np.asarray(jfin[k], np.float32)), k


def bf16(a):
    return a.dtype == ml_dtypes.bfloat16


def test_state_tree_round_trip_is_bitwise():
    jc, tc, batches = _world("bfloat16")
    jt, js = _jax_trainer(jc, "split", "dense", batches)
    js, _ = jt.train_step(js, batches[0])
    tree = tp.jax_state_tree(js)
    _, ts = _port_trainer(tc, "split", "dense", batches)
    interop.load_train_state(ts, tree)
    back = tp.flat_tree(interop.train_state_tree(ts, ml_dtypes.bfloat16))
    want = tp.flat_tree(tree)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == back[k].dtype and v.tobytes() == back[k].tobytes(), k
        else:
            assert v == back[k], k
    assert want["opt/count"] == want["step"] == 1


def test_batchnorm_training_matches_flax():
    """flax's train-mode BatchNorm: batch statistics with the biased
    variance, running statistics moved by momentum 0.99; outputs and input
    gradients at rtol 1e-5, running statistics at 1e-6. torch's BatchNorm1d
    moves the running variance with the unbiased variance instead."""
    import flax.linen as fnn
    import jax.numpy as jnp
    from recommendflow_tpu_torch.ops.mlp import BatchNorm
    rng = np.random.RandomState(0)
    x = (rng.randn(16, 8) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    mean0 = rng.randn(8).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 8).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, epsilon=1e-6, momentum=0.99)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def f(x_):
        y, upd = bn.apply(variables, x_, mutable=["batch_stats"])
        return jnp.sum(y * jnp.arange(8.0)), (y, upd)

    (_, (jy, jupd)), jgx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    tbn = BatchNorm(8)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(mean0))
        tbn.running_var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tbn.train()(tx)
    (ty * torch.arange(8.0)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(tbn, ours).numpy(),
                                   np.asarray(jupd["batch_stats"][theirs]),
                                   rtol=1e-6, atol=1e-6)
    ref = torch.nn.BatchNorm1d(8, eps=1e-6, momentum=0.01)
    ref.running_var.copy_(torch.from_numpy(var0))
    ref.train()(torch.from_numpy(x))
    assert not np.allclose(ref.running_var.numpy(), tbn.running_var.numpy(),
                           rtol=1e-6, atol=1e-6)


def test_row_injection_guard():
    """A model flagged row_injection whose training forward reads a table
    outside the injected embed pass is refused at init_state on the split
    path; Dssm passes, its split tables get no gradient, and the BatchNorm
    statistics are left as they were."""
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.ops.embedding import gather_group
    from recommendflow_tpu_torch.train.trainer import Trainer, table_params
    _, tc, batches = _world("float32")

    class Misflagged(Dssm):
        def forward(self, batch):
            out = super().forward(batch)
            if not self.training:
                return out
            loss, aux = out
            extra = gather_group(self.embedder.table_dim16,
                                 self.schema.groups[16],
                                 torch.from_numpy(batches[0]["clk_item_ids"]))
            return loss + extra.sum() * 0.0, aux

    bad = Misflagged(tc, device="cpu")
    with pytest.raises(ValueError, match="row_injection"):
        Trainer(bad, table_update="split", device="cpu").init_state(batches[0])
    good = Dssm(tc, device="cpu")
    before = {k: v.clone() for k, v in good.named_buffers()}
    t = Trainer(good, table_update="split", device="cpu")
    state = t.init_state(batches[0])
    for k, v in good.named_buffers():
        assert torch.equal(before[k], v), k
    assert all(p.grad is None for p in good.parameters())
    state, m = t.train_step(state, batches[0])
    assert np.isfinite(float(m["loss"]))
    assert all(p.grad is None for p in table_params(good).values())
    # the dense path takes the same model without the check
    Trainer(bad, table_update="dense", device="cpu").init_state(batches[0])


def test_trainer_refuses_what_is_not_ported():
    """An unknown split strategy is refused; table_update="sparse", which
    this test refused before it was ported, takes the touched-row path on
    every table and trains (tests/test_torch_sparse_update.py holds it
    against the JAX trainer)."""
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.train.trainer import Trainer
    _, tc, batches = _world("float32")
    model = Dssm(tc, device="cpu")
    t = Trainer(model, table_update="sparse", device="cpu")
    state = t.init_state(batches[0])
    assert t._sparse_dims == sorted(model.schema.groups) and not t._split_dims
    state, m = t.train_step(state, batches[1])
    assert np.isfinite(float(m["loss"])) and state.step == 1
    with pytest.raises(ValueError):
        Trainer(model, split_strategy="scatter", device="cpu")
