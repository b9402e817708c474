"""The port's table optimizers against recommendflow_tpu/train/optimizers.py.

The same numpy inputs go through the JAX function and the port's (the CPU
runs each kernel's plain version). Tolerances, with their reasons:

  * segment_row_grads: uid and valid equal; the f32 sums bitwise (both add
    a segment's rows in sorted order).
  * accumulators: rtol 1e-6 (a row's mean of squares is reduced in another
    order: one f32 ulp).
  * f32 tables: rtol 1e-6, atol 1e-8. XLA's rsqrt and torch's differ in the
    last bit for about a third of inputs, which moves an update by ~1e-7 of
    itself.
  * bf16 tables, "sparse_set" and "sparse": within one bf16 rounding (the
    spacing at the larger magnitude), for the same reasons.
  * bf16 tables, "dense": the port sums a row's duplicate gradients in f32
    and rounds once, the JAX strategy adds them into the bf16 table one by
    one. Against a JAX composition with the port's rounding (f32
    segment_row_grads, one rounding to bf16, the JAX dense apply) p is
    within one rounding; against the JAX strategy itself, rows touched once
    are within one rounding and the rest within rtol 2^-7 + atol 1e-3.
  * the dense-table apply (the trainer's table_update="dense" path) against
    optax's row-wise Adagrad, bf16: within one rounding plus 2^-8 of the
    update, since optax rounds the update to bf16 before adding it and the
    kernel rounds once.
Untouched rows are bitwise in every case.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu.train import optimizers as jopt
from recommendflow_tpu_torch.interop import to_numpy, to_tensor
from recommendflow_tpu_torch.train import optimizers as topt

R, W, N = 96, 64, 400
LR = 0.03


def _inputs(dtype, seed=0, id_hi=60):
    rng = np.random.RandomState(seed)
    p = rng.uniform(-0.05, 0.05, (R, W)).astype(np.float32)
    acc = rng.uniform(0.1, 1.0, (R, 1)).astype(np.float32)
    ids = rng.randint(0, id_hi, N).astype(np.int32)
    ids[:5] = [3, 3, 3, 3, 59]                 # a hot row and a cold one
    g = (rng.randn(N, W) * 0.05).astype(np.float32)
    if dtype == "bfloat16":
        p = p.astype(ml_dtypes.bfloat16)
        g = g.astype(ml_dtypes.bfloat16)
    return p, acc, ids, g


def _port(p, acc, ids, g, strategy):
    tp_, ta = to_tensor(p), to_tensor(acc)
    out_p, out_a = topt.split_table_update(tp_, ta, torch.from_numpy(ids),
                                           to_tensor(g), lr=LR,
                                           strategy=strategy)
    assert out_p is tp_ and out_a is ta           # in place
    return to_numpy(tp_, ml_dtypes.bfloat16), ta.numpy()


def _jax(p, acc, ids, g, strategy):
    jp, ja = jopt.split_table_update(jnp.asarray(p), jnp.asarray(acc),
                                     jnp.asarray(ids), jnp.asarray(g), lr=LR,
                                     strategy=strategy)
    return np.asarray(jp), np.asarray(ja)


def _bits(x):
    return tp.bf16_bits(x) if x.dtype == ml_dtypes.bfloat16 else x


def _close(got, want):
    """f32: rtol 1e-6, atol 1e-8; bf16: within one rounding."""
    if got.dtype == ml_dtypes.bfloat16:
        assert tp.bf16_ulp_err(got, want) <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def _untouched(ids):
    keep = np.ones(R, bool)
    keep[ids] = False
    return keep


def test_segment_row_grads_matches():
    rng = np.random.RandomState(1)
    s = np.sort(rng.randint(0, 50, N)).astype(np.int32)
    gs = rng.randn(N, W).astype(np.float32)
    js, ju, jv = jopt.segment_row_grads(jnp.asarray(s), jnp.asarray(gs),
                                        num_rows=R)
    from recommendflow_tpu_torch.ops.cuda.embedding_bag import (
        segment_row_grads)
    ts, tu, tv, tn = segment_row_grads(torch.from_numpy(s),
                                       torch.from_numpy(gs), num_rows=R)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tn.dtype == torch.int32 and int(tn) == len(np.unique(s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", ["sparse_set", "sparse"])
def test_sparse_strategies(dtype, strategy):
    p, acc, ids, g = _inputs(dtype)
    tp_, ta = _port(p, acc, ids, g, strategy)
    jp, ja = _jax(p, acc, ids, g, strategy)
    _close(tp_, jp)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    keep = _untouched(ids)
    np.testing.assert_array_equal(_bits(tp_[keep]), _bits(p[keep]))
    np.testing.assert_array_equal(ta[keep], acc[keep])


def test_dense_strategy_f32():
    p, acc, ids, g = _inputs("float32")
    tp_, ta = _port(p, acc, ids, g, "dense")
    jp, ja = _jax(p, acc, ids, g, "dense")
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    _close(tp_, jp)
    keep = _untouched(ids)
    np.testing.assert_array_equal(tp_[keep], p[keep])


def _jax_dense_f32_sums(p, acc, ids, g):
    """The JAX dense strategy with the port's rounding point: duplicates
    summed in f32 (segment_row_grads), rounded once into the bf16 table."""
    s = np.sort(ids, kind="stable")
    order = np.argsort(ids, kind="stable")
    summed, uid, _ = jopt.segment_row_grads(
        jnp.asarray(s), jnp.asarray(g)[order].astype(jnp.float32), num_rows=R)
    gd = jnp.zeros((R, W), jnp.float32).at[uid].add(summed, mode="drop")
    g32 = gd.astype(p.dtype).astype(jnp.float32)
    acc2 = acc + jnp.mean(g32 * g32, axis=1, keepdims=True)
    p2 = (jnp.asarray(p).astype(jnp.float32)
          - LR * g32 * jax.lax.rsqrt(acc2 + 1e-10))
    return np.asarray(p2.astype(p.dtype)), np.asarray(acc2)


def test_dense_strategy_bf16():
    p, acc, ids, g = _inputs("bfloat16")
    tp_, ta = _port(p, acc, ids, g, "dense")
    rp, ra = _jax_dense_f32_sums(p, acc, ids, g)
    np.testing.assert_allclose(ta, ra, rtol=1e-6)
    _close(tp_, rp)
    jp, ja = _jax(p, acc, ids, g, "dense")
    once = np.bincount(ids, minlength=R) == 1
    _close(tp_[once], jp[once])
    np.testing.assert_allclose(tp_.astype(np.float32), jp.astype(np.float32),
                               rtol=2 ** -7, atol=1e-3)
    keep = _untouched(ids)
    np.testing.assert_array_equal(tp.bf16_bits(tp_[keep]), tp.bf16_bits(p[keep]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_table_apply_matches_optax_rowwise_adagrad(dtype):
    """The trainer's table_update='dense' apply (rowwise_adagrad_update on a
    dense table gradient) against optax's row-wise Adagrad."""
    from recommendflow_tpu_torch.ops.cuda.table_update import (
        rowwise_adagrad_update)
    rng = np.random.RandomState(2)
    p, acc, _, _ = _inputs(dtype)
    g = np.zeros((R, W), np.float32)
    rows = rng.choice(R, 40, replace=False)
    g[rows] = rng.randn(40, W) * 0.05
    g = g.astype(p.dtype)
    tx = jopt.rowwise_adagrad(LR)
    upd, st = tx.update({"t": jnp.asarray(g)},
                        jopt.RowwiseAdagradState({"t": jnp.asarray(acc)}))
    jp = np.asarray(jnp.asarray(p) + upd["t"])
    ja = np.asarray(st.accumulator["t"])
    tp_, ta = to_tensor(p), to_tensor(acc)
    rowwise_adagrad_update(tp_, ta, to_tensor(g), lr=LR)
    tp_ = to_numpy(tp_, ml_dtypes.bfloat16)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-6)
    if dtype == "float32":
        _close(tp_, jp)
    else:
        t32, j32 = tp_.astype(np.float32), jp.astype(np.float32)
        spacing = np.exp2(np.floor(np.log2(np.maximum(
            np.maximum(np.abs(t32), np.abs(j32)), 2.0 ** -126))) - 7)
        upd = np.abs(np.asarray(upd["t"], np.float32))
        assert (np.abs(t32 - j32) <= spacing + 2 ** -8 * upd).all()
    keep = np.ones(R, bool)
    keep[rows] = False
    np.testing.assert_array_equal(_bits(tp_[keep]), _bits(p[keep]))


def test_unknown_strategy_and_accumulator_seed():
    p, acc, ids, g = _inputs("float32")
    with pytest.raises(ValueError, match="strategy"):
        _port(p, acc, ids, g, "scatter")
    assert topt.ADAGRAD_INIT_ACCUMULATOR == jopt.ADAGRAD_INIT_ACCUMULATOR
    assert topt.default_table_lr(1e-3) == jopt.default_table_lr(1e-3)
    assert topt.default_table_lr(1e-5) == jopt.default_table_lr(1e-5)
    a = topt.init_accumulator(torch.zeros(7, 3, dtype=torch.bfloat16))
    assert a.shape == (7, 1) and a.dtype == torch.float32
    assert float(a.min()) == float(a.max()) == np.float32(0.1)
