"""The plain versions of the table kernels against their Pallas functions (in
interpret mode) and against the XLA paths the JAX trainer runs:

  * scatter_add_rows: Pallas scatter_add_rows and XLA `.at[uid].add`:
    bitwise, f32 and bf16 tables (the gradients are bf16 values for a bf16
    table, which Pallas adds in bf16: one rounding on both sides). Entries
    past n_valid and ids outside the table are never applied.
  * rowwise_adagrad_update: Pallas rowwise_adagrad_update and the jnp apply
    of split_table_update's "dense" strategy: acc rtol 1e-6; p f32 rtol
    1e-6 + atol 1e-8, bf16 within one rounding (a row's mean is reduced in
    another order, and XLA's rsqrt differs from torch's in the last bit).
  * sparse_adagrad_apply: Pallas sparse_adagrad_apply (with _compact_sorted
    and split_update_pallas) and the XLA "sparse_set" strategy: the same
    tolerances; untouched rows bitwise.
  * take_rows' gradient: the XLA custom VJP of ops/embedding.py:take_rows
    and the Pallas take_rows' VJP (_combine_duplicates + scatter_add_rows):
    f32 rtol 1e-6; bf16 rows with one gradient bitwise, rows with
    duplicates within rtol 2^-5 (the JAX backwards add duplicates one by one
    in bf16, the port sums them in f32 and rounds once: bitwise against
    that f32 sum).
  * gather_group's wide-row select and its gradient: equal values to the
    JAX one-hot select.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch.interop import to_numpy, to_tensor
from recommendflow_tpu_torch.ops.cuda import (embedding_bag, sparse_apply,
                                              table_update)

LR = 0.05


def _np(t):
    return to_numpy(t, ml_dtypes.bfloat16)


def _close(got, want):
    if got.dtype == ml_dtypes.bfloat16:
        assert tp.bf16_ulp_err(got, want) <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_add_rows_plain_matches_pallas_and_xla(dtype):
    from recommendflow_tpu.ops.pallas.embedding_bag import scatter_add_rows
    rng = np.random.RandomState(1)
    R, W, n = 500, 128, 200
    table = rng.randn(R, W).astype(np.float32)
    uids = rng.permutation(R)[:n + 40].astype(np.int32)
    uids[n:] = uids[0]                  # a padded tail repeating a real id
    grads = rng.randn(n + 40, W).astype(np.float32)
    if dtype == "bfloat16":
        table = table.astype(ml_dtypes.bfloat16)
        grads = grads.astype(ml_dtypes.bfloat16).astype(np.float32)
    n_valid = np.int32(n)
    jt = jnp.asarray(table)
    a = np.asarray(scatter_add_rows(jnp.asarray(uids), jnp.asarray(grads), jt,
                                    n_valid=n_valid, interpret=True))
    b = np.asarray(jt.at[uids[:n]].add(jnp.asarray(grads[:n]).astype(jt.dtype)))
    t = to_tensor(table)
    before = embedding_bag.scatter_add_rows.launches
    out = embedding_bag.scatter_add_rows(
        torch.from_numpy(uids), torch.from_numpy(grads), t,
        torch.tensor([n], dtype=torch.int32))
    assert out is t and embedding_bag.scatter_add_rows.launches == before
    bits = tp.bf16_bits if dtype == "bfloat16" else np.asarray
    np.testing.assert_array_equal(bits(_np(t)), bits(a))
    np.testing.assert_array_equal(bits(_np(t)), bits(b))
    # ids outside [0, R) are skipped, as the split path's padding is
    t2 = to_tensor(table)
    embedding_bag.scatter_add_rows_plain(
        torch.tensor([R, R + 7, 3], dtype=torch.int32),
        torch.ones((3, W)), t2)
    moved = (_np(t2).astype(np.float32) != table.astype(np.float32)).any(1)
    assert moved.tolist() == [i == 3 for i in range(R)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rowwise_adagrad_update_plain_matches_pallas_and_xla(dtype):
    from recommendflow_tpu.ops.pallas.table_update import rowwise_adagrad_update
    rng = np.random.RandomState(7)
    R, W = 300, 128
    p = rng.randn(R, W).astype(np.float32)
    g = (rng.randn(R, W) * 1e-2).astype(np.float32)
    g[::3] = 0.0                                     # untouched rows
    acc = (rng.rand(R, 1) + 0.1).astype(np.float32)
    if dtype == "bfloat16":
        p, g = p.astype(ml_dtypes.bfloat16), g.astype(ml_dtypes.bfloat16)
    jp, ja = rowwise_adagrad_update(jnp.asarray(p), jnp.asarray(acc),
                                    jnp.asarray(g), lr=LR, block_rows=128,
                                    interpret=True)
    g32 = jnp.asarray(g).astype(jnp.float32)
    xa = jnp.asarray(acc) + jnp.mean(g32 * g32, axis=1, keepdims=True)
    xp = (jnp.asarray(p).astype(jnp.float32)
          - LR * g32 * jax.lax.rsqrt(xa + 1e-10)).astype(jnp.asarray(p).dtype)
    tp_, ta = to_tensor(p), to_tensor(acc)
    table_update.rowwise_adagrad_update(tp_, ta, to_tensor(g), lr=LR)
    for ref_p, ref_a in ((jp, ja), (xp, xa)):
        np.testing.assert_allclose(ta.numpy(), np.asarray(ref_a), rtol=1e-6)
        _close(_np(tp_), np.asarray(ref_p))
    bits = tp.bf16_bits if dtype == "bfloat16" else np.asarray
    np.testing.assert_array_equal(bits(_np(tp_)[::3]), bits(p[::3]))
    np.testing.assert_array_equal(ta.numpy()[::3], acc[::3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_adagrad_apply_plain_matches_pallas_and_xla(dtype):
    from recommendflow_tpu.ops.pallas.sparse_apply import (
        _compact_sorted, sparse_adagrad_apply, split_update_pallas)
    from recommendflow_tpu.train.optimizers import split_table_update
    rng = np.random.default_rng(0)
    R, W, n = 4096, 256, 700
    p = rng.standard_normal((R, W)).astype(np.float32)
    acc = rng.uniform(0.1, 1.0, (R, 1)).astype(np.float32)
    ids = rng.integers(0, R, n).astype(np.int32)
    g = (rng.standard_normal((n, W)) * 0.01).astype(np.float32)
    if dtype == "bfloat16":
        p = p.astype(ml_dtypes.bfloat16)
    jp_, ja_, jids, jg = map(jnp.asarray, (p, acc, ids, g))
    uid2d, gs32, starts, overflow = _compact_sorted(jp_, jids, jg, 512, 2048)
    assert not bool(overflow)
    kp, ka = sparse_adagrad_apply(jp_, ja_, uid2d, gs32, starts, lr=LR,
                                  interpret=True)
    fp, fa = split_update_pallas(jp_, ja_, jids, jg, lr=LR, interpret=True)
    xp, xa = split_table_update(jp_, ja_, jids, jg, lr=LR, strategy="sparse_set")
    # the plain version on the Pallas function's own compacted inputs
    # (padding uids carry R and are skipped)
    tp_, ta = to_tensor(p), to_tensor(acc)
    sparse_apply.sparse_adagrad_apply(
        tp_, ta, torch.from_numpy(np.asarray(uid2d)[:, 0].copy()),
        torch.from_numpy(np.array(gs32)), lr=LR)
    for ref_p, ref_a in ((kp, ka), (fp, fa), (xp, xa)):
        np.testing.assert_allclose(ta.numpy(), np.asarray(ref_a), rtol=1e-6)
        _close(_np(tp_), np.asarray(ref_p))
    keep = np.ones(R, bool)
    keep[ids] = False
    bits = tp.bf16_bits if dtype == "bfloat16" else np.asarray
    np.testing.assert_array_equal(bits(_np(tp_)[keep]), bits(p[keep]))
    np.testing.assert_array_equal(ta.numpy()[keep], acc[keep])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_gradient_matches_both_jax_vjps(dtype):
    from recommendflow_tpu.ops.embedding import take_rows as xla_take_rows
    from recommendflow_tpu.ops.pallas.embedding_bag import (
        _combine_duplicates, scatter_add_rows)
    from recommendflow_tpu_torch.ops.embedding import take_rows
    rng = np.random.RandomState(3)
    R, W, n = 200, 64, 500
    table = rng.randn(R, W).astype(np.float32)
    ids = rng.randint(0, 150, n).astype(np.int32)
    ct = rng.randn(n, W).astype(np.float32)
    if dtype == "bfloat16":
        table, ct = table.astype(ml_dtypes.bfloat16), ct.astype(ml_dtypes.bfloat16)
    jt, jids, jct = jnp.asarray(table), jnp.asarray(ids), jnp.asarray(ct)
    out, vjp = jax.vjp(lambda t: xla_take_rows(t, jids), jt)
    (x_grad,) = vjp(jct)
    uniq, summed, n_uniq = _combine_duplicates(jids, jct)
    p_grad = scatter_add_rows(uniq, summed, jnp.zeros_like(jt), n_valid=n_uniq,
                              interpret=True)
    tt = to_tensor(table).requires_grad_()
    rows = take_rows(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(rows.detach()).astype(np.float32),
                                  np.asarray(out).astype(np.float32))
    rows.backward(to_tensor(ct))
    got = _np(tt.grad)
    assert got.dtype == table.dtype and got.shape == table.shape
    counts = np.bincount(ids, minlength=R)
    exact = np.zeros((R, W), np.float32)
    np.add.at(exact, ids, ct.astype(np.float32))
    if dtype == "float32":
        for ref in (x_grad, p_grad):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6,
                                       atol=1e-6)
        return
    np.testing.assert_array_equal(tp.bf16_bits(got),
                                  tp.bf16_bits(exact.astype(ml_dtypes.bfloat16)))
    for ref in (x_grad, p_grad):
        ref = np.asarray(ref)
        once = counts <= 1
        np.testing.assert_array_equal(tp.bf16_bits(got[once]),
                                      tp.bf16_bits(ref[once]))
        np.testing.assert_allclose(got.astype(np.float32),
                                   ref.astype(np.float32), rtol=2 ** -5,
                                   atol=2 ** -5 * np.abs(exact).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_row_select_and_gradient_bitwise(dtype):
    """gather_group on injected stored rows (the split path): the same
    values and the same [N, P*dim] row gradients as the JAX select."""
    from recommendflow_tpu.ops import embedding as jemb
    from recommendflow_tpu_torch.ops import embedding as temb
    jc, tc = tp.conf_pair()
    from recommendflow_tpu.data.schema import compile_schema as jcompile
    from recommendflow_tpu_torch.data.schema import compile_schema as tcompile
    jg, tg = jcompile(jc.features).groups[16], tcompile(tc.features).groups[16]
    rng = np.random.RandomState(5)
    shape = jemb.table_shape(jg, jnp.dtype(dtype))
    table = rng.uniform(-1, 1, shape).astype(np.float32)
    if dtype == "bfloat16":
        table = table.astype(ml_dtypes.bfloat16)
    gids = rng.randint(0, jg.total_rows, (6, 2, 5)).astype(np.int32)
    pid = np.asarray(jemb.physical_ids(jnp.asarray(table), 16,
                                       jnp.asarray(gids)))
    wide = table[pid]
    ct = rng.randn(6, 2, 5, 16).astype(np.float32)
    out, vjp = jax.vjp(lambda w: jemb.gather_group(jnp.asarray(table), jg,
                                                   jnp.asarray(gids),
                                                   wide_rows=w),
                       jnp.asarray(wide))
    (jgrad,) = vjp(jnp.asarray(ct))
    tw = to_tensor(wide).requires_grad_()
    tout = temb.gather_group(to_tensor(table), tg, torch.from_numpy(gids),
                             wide_rows=tw)
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(out))
    tout.backward(torch.from_numpy(ct))
    # equal values; the JAX one-hot product leaves -0.0 off the segment
    # where the port leaves +0.0
    np.testing.assert_array_equal(_np(tw.grad).astype(np.float32),
                                  np.asarray(jgrad).astype(np.float32))
    with pytest.raises(ValueError, match="wide_rows shape"):
        temb.gather_group(to_tensor(table), tg, torch.from_numpy(gids),
                          wide_rows=tw[:-1])
