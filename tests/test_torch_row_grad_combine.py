"""`combine_row_grads` (ops/cuda/row_grad_combine.py), the split table
update's duplicate sum over every split table of a step, on the CPU (its
plain version; the kernel's comparisons are in tests/test_torch_cuda.py).

Against a numpy reference per table (np.unique, f32 sums added in batch
order by np.add.at): uid, valid and n_valid exactly, summed within f32
reordering (rtol 1e-6, atol 1e-7). The grouped call equals each table's
own call bitwise, and every split strategy fed by the grouped call leaves
the tables and accumulators bitwise as `split_table_update` and as the
per-table sort and index_add_ the split path ran before.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch.interop import to_tensor
from recommendflow_tpu_torch.ops.cuda import row_grad_combine as rgc
from recommendflow_tpu_torch.ops.cuda.embedding_bag import segment_row_grads
from recommendflow_tpu_torch.train import optimizers as topt

# (n ids, width, stored rows, gradient dtype, how the ids repeat)
TABLES = [(400, 8, 90, "float32", "zipf"), (300, 32, 5000, "bfloat16", "zipf"),
          (257, 64, 3000, "float32", "unique"),
          (180, 339, 70, "bfloat16", "zipf"), (1, 32, 10, "float32", "zipf"),
          (96, 11, 40, "bfloat16", "same")]


def _table(n, width, rows, dtype, kind, rng):
    if kind == "unique":
        ids = rng.permutation(rows)[:n]
    elif kind == "same":
        ids = np.full(n, rows // 2)
    else:
        ids = (rng.zipf(1.2, n) - 1 + rows // 3) % rows
    g = (rng.randn(n, width) * 0.05).astype(np.float32)
    if dtype == "bfloat16":
        g = g.astype(ml_dtypes.bfloat16)
    return ids.astype(np.int32), g


def _tables(seed, specs=TABLES):
    rng = np.random.RandomState(seed)
    out = []
    for n, width, rows, dtype, kind in specs:
        ids, g = _table(n, width, rows, dtype, kind, rng)
        out.append((torch.from_numpy(ids), to_tensor(g), rows))
    return out


def _reference(ids, g, rows):
    ids = ids.numpy()
    g = g.float().numpy()
    uniq, seg = np.unique(ids, return_inverse=True)
    summed = np.zeros_like(g)
    order = np.argsort(ids, kind="stable")
    np.add.at(summed, seg[order], g[order])
    n, k = len(ids), len(uniq)
    uid = np.concatenate([uniq, rows + np.arange(k, n)]).astype(np.int32)
    return summed, uid, np.arange(n) < k, k


def _check(got, want):
    summed, uid, valid, n_valid = got
    r_summed, r_uid, r_valid, r_n = want
    assert n_valid.dtype == torch.int32 and n_valid.shape == (1,)
    assert int(n_valid) == r_n
    np.testing.assert_array_equal(uid.numpy(), r_uid)
    np.testing.assert_array_equal(valid.numpy(), r_valid)
    assert summed.dtype == torch.float32
    np.testing.assert_allclose(summed.numpy(), r_summed, rtol=1e-6, atol=1e-7)
    assert not summed[r_n:].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_grouped_matches_reference_and_each_table_alone(seed):
    tables = _tables(seed)
    grouped = rgc.combine_row_grads(tables)
    assert len(grouped) == len(tables)
    for (ids, g, rows), got in zip(tables, grouped):
        _check(got, _reference(ids, g, rows))
        alone, = rgc.combine_row_grads([(ids, g, rows)])
        for a, b in zip(got, alone):
            assert torch.equal(a, b)


def test_segment_row_grads_is_the_one_table_call():
    ids, g, rows = _tables(2)[1]
    s, order = torch.sort(ids, stable=True)
    got = segment_row_grads(s, g[order].float(), num_rows=rows)
    want, = rgc.combine_row_grads([(ids, g, rows)])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_out_of_range_ids_count_as_num_rows():
    ids = torch.tensor([5, -1, 2, 12, 5, 10], dtype=torch.int32)
    g = torch.arange(12.0).reshape(6, 2)
    summed, uid, valid, n_valid = rgc.combine_row_grads([(ids, g, 10)])[0]
    assert uid.tolist() == [2, 5, 10, 13, 14, 15]
    assert valid.tolist() == [True] * 3 + [False] * 3 and int(n_valid) == 3
    # the bad ids' run sums in batch order: -1, 12, 10
    assert summed[2].tolist() == [2.0 + 6.0 + 10.0, 3.0 + 7.0 + 11.0]


def test_an_empty_table_in_a_group():
    tables = _tables(3)[:2]
    empty = (torch.zeros(0, dtype=torch.int32), torch.zeros((0, 16)), 50)
    out = rgc.combine_row_grads([tables[0], empty, tables[1]])
    summed, uid, valid, n_valid = out[1]
    assert summed.shape == (0, 16) and summed.dtype == torch.float32
    assert uid.numel() == 0 and valid.numel() == 0 and int(n_valid) == 0
    _check(out[2], _reference(*tables[1]))


def test_plan_layout():
    specs = [(n, w, r) for n, w, r, _, _ in TABLES]
    lay = rgc.plan_layout(*zip(*specs))
    ns = [n for n, _, _ in specs]
    assert lay.off == tuple(np.cumsum([0] + ns[:-1]))
    assert lay.n_total == sum(ns)
    chunks = [-(-n // rgc.CHUNK) for n in ns]
    assert lay.chunk0 == tuple(np.cumsum([0] + chunks[:-1]))
    assert lay.n_chunks == sum(chunks)
    for t, (n, w, _) in enumerate(specs):
        assert lay.summed_off[t] % 4 == 0 and lay.carry_off[t] % 4 == 0
        end = lay.summed_off[t + 1] if t + 1 < len(specs) else lay.summed_floats
        assert end - lay.summed_off[t] >= n * w
        end = lay.carry_off[t + 1] if t + 1 < len(specs) else lay.carry_floats
        assert end - lay.carry_off[t] >= chunks[t] * w
    # rows 0..5000 (5000 is an out-of-range id) and six tables
    assert lay.row_bits == 13 and lay.key_bits == 16 and not lay.key64


@pytest.mark.parametrize("rows,count,bits,key64", [
    (10_131_227, 23, 29, False),        # Dcn/Criteo's widest table
    (1_505_002, 2, 22, False),          # Dssm's dim-64 table
    ((1 << 31) - 1024, 1, 31, False),
    ((1 << 29) + 7, 16, 34, True)])
def test_key_bits(rows, count, bits, key64):
    lay = rgc.plan_layout([64] * count, [8] * count, [rows] + [3] * (count - 1))
    assert lay.key_bits == bits and lay.key64 == key64


def test_sixty_four_bit_keys_combine():
    specs = [(300, 32, (1 << 29) + 7, "float32", "zipf")] + \
        [(40, 8, 1000, "bfloat16", "zipf")] * 15
    tables = _tables(4, specs)
    assert rgc.plan_layout([t[0].numel() for t in tables],
                           [t[1].shape[1] for t in tables],
                           [t[2] for t in tables]).key64
    for t, got in zip(tables, rgc.combine_row_grads(tables)):
        _check(got, _reference(*t))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("strategy", topt.STRATEGIES)
def test_strategies_fed_by_the_grouped_call(strategy):
    rng = np.random.RandomState(5)
    updates, per_table = [], []
    for (ids, g, rows), dtype in zip(_tables(6)[:4], ["bfloat16", "float32",
                                                      "bfloat16", "float32"]):
        p = rng.uniform(-0.05, 0.05, (rows, g.shape[1])).astype(np.float32)
        p = to_tensor(p.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
                      else p)
        acc = torch.from_numpy(rng.uniform(0.1, 1.0, (rows, 1)).astype(
            np.float32))
        updates.append((p.clone(), acc.clone(), ids, g, strategy))
        per_table.append((p, acc, ids, g))
    topt.split_tables_update(updates, lr=0.03)
    for (p, acc, ids, g), (gp, gacc, *_) in zip(per_table, updates):
        p1, acc1 = p.clone(), acc.clone()
        out_p, out_a = topt.split_table_update(p, acc, ids, g, lr=0.03,
                                               strategy=strategy)
        assert out_p is p and out_a is acc
        assert torch.equal(_bits(gp), _bits(p)) and torch.equal(gacc, acc)
        _update_per_table(p1, acc1, ids, g, strategy, lr=0.03)
        assert torch.equal(_bits(gp), _bits(p1)) and torch.equal(gacc, acc1)


def _update_per_table(p, acc, ids, g, strategy, lr, eps=1e-10):
    """The split update as each table ran it alone before the grouped call:
    sort, compact, index_add_ the f32 sums, then the strategy."""
    from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
    from recommendflow_tpu_torch.ops.cuda import sparse_apply, table_update
    s, order = torch.sort(ids, stable=True)
    uid, valid, n_valid, seg = kr.unique_sorted(s, num_rows=p.shape[0])
    gs = g[order].float()
    summed = torch.zeros_like(gs).index_add_(0, seg, gs)
    if strategy == "dense":
        gd = torch.zeros_like(p)
        kr.scatter_add_rows(uid, summed, gd, n_valid)
        table_update.rowwise_adagrad_update(p, acc, gd, lr=lr, eps=eps)
    elif strategy == "sparse_set":
        sparse_apply.sparse_adagrad_apply(p, acc, uid, summed, n_valid, lr=lr,
                                          eps=eps)
    else:
        rows = torch.where(valid, uid, s[-1]).long()
        d_acc = torch.where(valid[:, None],
                            (summed * summed).mean(dim=1, keepdim=True), 0.0)
        acc.index_add_(0, rows, d_acc)
        upd = torch.where(valid[:, None],
                          -lr * summed * torch.rsqrt(acc[rows] + eps), 0.0)
        p.index_add_(0, rows, upd.to(p.dtype))


def test_unknown_strategy_raises_before_any_update():
    ids, g, rows = _tables(7)[0]
    p, acc = torch.zeros((rows, g.shape[1])), torch.ones((rows, 1))
    with pytest.raises(ValueError, match="unknown split strategy"):
        topt.split_tables_update([(p, acc, ids, g, "dense"),
                                  (p, acc, ids, g, "rowwise")], lr=0.1)
    assert not p.any()


def test_trainer_combines_every_split_table_once_a_step(monkeypatch):
    """The split path's table update makes one grouped call a step, over
    every split table (demo_recall: dim8 and dim16)."""
    calls = []
    real = topt.combine_row_grads

    def counting(tables):
        calls.append([g.shape[1] for _, g, _ in tables])
        return real(tables)
    monkeypatch.setattr(topt, "combine_row_grads", counting)
    t = tp.demo_trainer({"tower_units": [64, 32]}, split_strategy="auto")
    batches = tp.demo_batches(3, seed=11).batches
    state = t.init_state(batches[0])
    assert len(t._split_dims) == 2
    calls.clear()
    for b in batches:
        t.train_step(state, b)
    assert len(calls) == 3 and all(len(c) == 2 for c in calls)
