"""The touched-row table update (Trainer(table_update="sparse"), and the
legacy planner that "auto" runs for a model without row_injection) against
the JAX package.

  * `touched_stored_rows` equal to the JAX function's ids on the same batch.
  * `sparse_rowwise_adagrad_update` (unique_sorted, gather_rows,
    sparse_adagrad_apply; their plain versions here) against the JAX
    package's `sparse_rowwise_adagrad_update` on one table, sorted ids with
    duplicates: f32 and bf16 tables; p within 1 ulp of its dtype [0
    measured], acc within rtol 1e-6 (the row mean summed in another
    order), untouched rows bitwise; and against the port's plain version
    (the JAX form in torch) in the same way.
  * Three carried `table_update="sparse"` steps of Dssm on
    conf/demo_recall.yaml (dropout 0, batches of 64) against the JAX
    Trainer(table_update="sparse"), as tests/test_torch_train.py holds the
    other modes and with its tolerances per table dtype: f32 losses rtol
    1e-5 and every float leaf atol 1e-5; bf16 those of its "dense" mode
    (losses rtol 1e-3, tables 1 ulp + atol 0.03, other leaves atol 6e-3),
    because JAX's dense table gradient adds a hot row's duplicate gradients
    into the bf16 table one by one where the port's sums them in f32 and
    rounds once. Rows no batch touched are bit-equal.
  * The legacy planner's choice on the demo tables (its cost model's) and
    when forced; Que2Search's "auto" reaching the touched-row path.
  * A checkpoint round trip of the accumulators (`table_acc`).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop
from test_torch_train import _tolerances, bf16

NETS = {"tower_units": [64, 32]}


def _world(table_dtype, n=4):
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    jc, tc = tp.conf_pair(networks=dict(NETS, table_dtype=table_dtype))
    batches = [synthetic_batch(compile_schema(jc.features), 64, seed=80 + i)
               for i in range(n)]
    return jc, tc, batches


def test_touched_stored_rows_match_jax():
    import jax.numpy as jnp
    from recommendflow_tpu.ops.embedding import touched_stored_rows as jrows
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.ops.embedding import touched_stored_rows
    for dtype in ("float32", "bfloat16"):
        jc, tc, batches = _world(dtype, 1)
        model = Dssm(tc, device="cpu")
        tables = {f"dim{d}": getattr(model.embedder, f"table_dim{d}")
                  for d in model.schema.groups}
        got = touched_stored_rows(model.schema, tables, tp.to_torch(batches[0]))
        want = jrows(model.schema, {k: jnp.zeros(t.shape) for k, t in
                                    tables.items()}, tp.to_jax(batches[0]))
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            # sorted, duplicates kept, stored rows (packed P per row)
            assert got[k].numel() > torch.unique(got[k]).numel()


def _update_inputs(dtype, seed=0):
    rng = np.random.RandomState(seed)
    rows, width = 50, 32
    p = rng.randn(rows, width).astype(np.float32)
    acc = rng.uniform(0.1, 1.0, (rows, 1)).astype(np.float32)
    g = (rng.randn(rows, width) * 0.1).astype(np.float32)
    sids = np.sort(rng.randint(0, rows, 90)).astype(np.int32)
    if dtype == "bfloat16":
        p = p.astype(ml_dtypes.bfloat16)
        g = g.astype(ml_dtypes.bfloat16)
    return p, acc, g, sids


def _hold_update(p, acc, p_ref, acc_ref, p0, sids):
    touched = np.zeros(p.shape[0], bool)
    touched[sids] = True
    bits = tp.bf16_bits if p.dtype == ml_dtypes.bfloat16 else \
        (lambda x: np.asarray(x).view(np.uint32))
    np.testing.assert_array_equal(bits(p[~touched]), bits(p0[~touched]))
    assert tp.bf16_ulp_err(p, p_ref) <= 1 if p.dtype == ml_dtypes.bfloat16 \
        else np.allclose(p, p_ref, rtol=2 ** -23, atol=0)
    np.testing.assert_allclose(acc, acc_ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sparse_update_matches_jax(dtype):
    import jax.numpy as jnp
    from recommendflow_tpu.train.optimizers import \
        sparse_rowwise_adagrad_update as jupdate
    from recommendflow_tpu_torch.train.optimizers import (
        sparse_rowwise_adagrad_update, sparse_rowwise_adagrad_update_plain)
    p, acc, g, sids = _update_inputs(dtype)
    jp, jacc = jupdate(jnp.asarray(p), jnp.asarray(acc), jnp.asarray(g),
                       jnp.asarray(sids), lr=0.05)
    jp, jacc = np.asarray(jp), np.asarray(jacc)
    tp_, tacc = interop.to_tensor(p), torch.from_numpy(acc.copy())
    sparse_rowwise_adagrad_update(tp_, tacc, interop.to_tensor(g),
                                  torch.from_numpy(sids), lr=0.05)
    got = interop.to_numpy(tp_, ml_dtypes.bfloat16)
    _hold_update(got, tacc.numpy(), jp, jacc, p, sids)
    pp, pacc = interop.to_tensor(p), torch.from_numpy(acc.copy())
    sparse_rowwise_adagrad_update_plain(pp, pacc, interop.to_tensor(g),
                                        torch.from_numpy(sids), lr=0.05)
    _hold_update(got, tacc.numpy(), interop.to_numpy(pp, ml_dtypes.bfloat16),
                 pacc.numpy(), p, sids)


def _jax_sparse(jc, batches):
    from recommendflow_tpu.models.base import build_network
    from recommendflow_tpu.train.trainer import Trainer
    model, _ = build_network(jc.networks["class"], {"conf": jc, "dropout": 0.0})
    t = Trainer(model, learning_rate=1e-3, table_update="sparse", seed=0)
    state = t.init_state(t._put(batches[0]))
    assert t._sparse_dims and not t._split_dims
    return t, state


def _port(tc, **kw):
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer
    model, _ = build_network(tc.networks["class"],
                             {"conf": tc, "dropout": 0.0, "device": "cpu"})
    return Trainer(model, learning_rate=1e-3, device="cpu", **kw)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_three_sparse_steps_match_jax(table_dtype):
    from recommendflow_tpu_torch.ops.embedding import touched_stored_rows
    jc, tc, batches = _world(table_dtype)
    jt, js = _jax_sparse(jc, batches)
    js, _ = jt.train_step(js, batches[0])            # non-trivial state
    tt = _port(tc, table_update="sparse")
    ts = tt.init_state(batches[0])
    assert tt._sparse_dims == sorted(jt._sparse_dims) and not tt._split_dims
    interop.load_train_state(ts, tp.jax_state_tree(js))
    jl, tl = [], []
    for b in batches[1:]:
        js, jm = jt.train_step(js, b)
        ts, tm = tt.train_step(ts, b)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    jfin = tp.flat_tree(tp.jax_state_tree(js))
    tfin = tp.flat_tree(interop.train_state_tree(ts, ml_dtypes.bfloat16))
    loss_rtol, table_atol, atol = _tolerances(table_dtype, "dense")
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    assert sorted(jfin) == sorted(tfin)
    tables = {f"dim{d}": getattr(tt.model.embedder, f"table_dim{d}")
              for d in tt.model.schema.groups}
    touched = {}
    for b in batches[1:]:
        for k, r in touched_stored_rows(tt.model.schema, tables,
                                        tp.to_torch(b)).items():
            touched.setdefault(k, set()).update(r.tolist())
    for k, a in jfin.items():
        b = tfin[k]
        if not isinstance(a, np.ndarray):
            assert a == b, k
            continue
        if "table_dim" in k or k.startswith("table_acc/"):
            rows = np.ones(a.shape[0], bool)
            rows[sorted(touched[k.split("/")[-1].replace("table_", "")])] \
                = False
            bits = tp.bf16_bits if bf16(a) else np.asarray
            np.testing.assert_array_equal(bits(b[rows]), bits(a[rows]), k)
        if "table_dim" in k:
            np.testing.assert_allclose(
                b.astype(np.float32), a.astype(np.float32),
                rtol=2 ** -7 if bf16(a) else 0, atol=table_atol, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=k)


def test_the_legacy_planner_on_the_demo_tables():
    """"auto" on a model without row_injection asks the legacy cost model
    per table (the demo tables are small: the whole-table update wins);
    "sparse" takes the touched rows on every table; "dense" on none."""
    from recommendflow_tpu_torch.models.matching.mobius import Mobius
    from recommendflow_tpu_torch.train import trainer as tr
    _, tc, batches = _world("float32", 1)
    tables = None
    for mode, want in (("auto", None), ("sparse", "all"), ("dense", "none")):
        model = Mobius(tc, device="cpu")
        model.row_injection = False
        t = tr.Trainer(model, table_update=mode, device="cpu")
        t.init_state(batches[0])
        tables = tr.table_params(model)
        n_ids = {}
        for name in model.schema.order:
            slot = model.schema.slots[name]
            if slot.kind == "sparse":
                n_ids[slot.dim] = n_ids.get(slot.dim, 0) + \
                    batches[0][name].size
        by_model = [d for d in sorted(tables) if tr.plan_table_update(
            tables[d].numel() * tables[d].element_size(), n_ids[d]) == "sparse"]
        expect = {None: by_model, "all": sorted(tables), "none": []}[want]
        assert t._sparse_dims == expect, mode
        assert not t._split_dims
    assert by_model == []
    dense, sparse = tr.table_update_costs(1 << 30, 100_000)
    assert dense == pytest.approx(tr.LEGACY_DENSE_S_PER_BYTE * (1 << 30))
    assert sparse == pytest.approx(tr.LEGACY_SPARSE_S_PER_ID * 100_000
                                   + tr.LEGACY_SPARSE_FIXED_S)
    even = sparse / tr.LEGACY_DENSE_S_PER_BYTE
    assert tr.plan_table_update(int(even * 0.9), 100_000) == "dense"
    assert tr.plan_table_update(int(even * 1.1), 100_000) == "sparse"


def test_que2search_auto_reaches_the_touched_row_path(tmp_path, monkeypatch):
    """Que2Search has no row_injection: "auto" runs the legacy planner. At
    the demo widths it takes the whole-table update; with a whole-table
    pass made costly it takes the touched rows, and a step there equals one
    under table_update="sparse" bit for bit."""
    from test_torch_matching import CASES, model_batch, port_kw
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train import trainer as tr
    _, tc, b0 = model_batch("que2search", str(tmp_path), b=32, seed=5)
    b1 = model_batch("que2search", str(tmp_path), b=32, seed=6)[2]
    _, path, kw, _ = CASES["que2search"]

    def one_step(mode):
        torch.manual_seed(0)
        model, _ = build_network(path, {"conf": tc, "device": "cpu",
                                        **port_kw(path, dict(kw, dropout=0.0))})
        t = tr.Trainer(model, table_update=mode, device="cpu")
        state = t.init_state(b0)
        state, m = t.train_step(state, b1)
        assert np.isfinite(float(m["loss"]))
        return t, model

    t, _ = one_step("auto")
    assert not t.split and t._sparse_dims == []
    monkeypatch.setattr(tr, "LEGACY_DENSE_S_PER_BYTE", 1.0)
    t, auto = one_step("auto")
    assert t._sparse_dims == sorted(tr.table_params(auto))
    _, forced = one_step("sparse")
    for (k, a), (_, b) in zip(auto.state_dict().items(),
                              forced.state_dict().items()):
        assert torch.equal(a, b), k


def test_table_acc_checkpoint_round_trip(tmp_path):
    """The touched-row path's accumulators go through save_checkpoint and
    restore_checkpoint bit for bit, and the restored state's next step
    equals the original's."""
    from recommendflow_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)
    _, tc, batches = _world("bfloat16")
    t = _port(tc, table_update="sparse")
    state = t.init_state(batches[0])
    state, _ = t.train_step(state, batches[0])
    path = save_checkpoint(str(tmp_path / "c.pt"), state)
    t2 = _port(tc, table_update="sparse")
    state2 = restore_checkpoint(path, t2.init_state(batches[0]))
    for k, v in state.table_acc.items():
        assert torch.equal(state2.table_acc[k], v) and \
            not torch.all(v == 0.1), k
    state, m = t.train_step(state, batches[1])
    state2, m2 = t2.train_step(state2, batches[1])
    assert float(m["loss"]) == float(m2["loss"]) and state2.step == 2
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              state2.model.state_dict().items()):
        assert torch.equal(a, b), k
    for k in state.table_acc:
        assert torch.equal(state.table_acc[k], state2.table_acc[k]), k
