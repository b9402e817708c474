"""The plain reference against the program at small sizes on the CPU: the
same layout, the same evaluation outputs from the same weights, the same
first training step, the same table update and the same top-k."""
import numpy as np
import pytest
import torch

from portbench.harness.cell import Cell
from portbench.harness.paths import make_path, tensors
from portbench.harness.traffic import zipf_batch
from portbench.reference.common import (Precision, exact_scores,
                                        normalize_rows, pooled_features,
                                        rowwise_adagrad, stored_row_grads,
                                        Rows)
from portbench.reference.layout import Layout
from portbench.tests.small import small_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("config", ["dssm_recall", "dcn_criteo"])
def test_layout_is_the_programs(config):
    from recommendflow_tpu_torch.config.configuration import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    from recommendflow_tpu_torch.ops.embedding import pack_factor, padded_rows
    cfg = Cell(f"{config}-train_zipf").config
    schema = compile_schema(Configuration(conf=cfg["port_conf"]).features)
    lay = Layout(cfg)
    assert [f["name"] for f in lay.features] == schema.order
    assert lay.labels == schema.label_names
    assert sorted(lay.groups) == sorted(schema.groups)
    for d, g in schema.groups.items():
        ours = lay.groups[d]
        assert ours.rows == g.total_rows
        assert ours.pack == pack_factor(d, "bfloat16")
        assert ours.logical_rows == padded_rows(g, "bfloat16")
        for t, off in zip(g.tables, g.offsets):
            assert ours.offsets[(t.feature, t.branch)] == off
    for f in lay.features:
        s = schema.slots[f["name"]]
        assert Layout.width(f) == s.out_dim


@pytest.mark.parametrize("workload", ["dssm_recall-serve_top100", "dcn_criteo-score_2048"])
def test_evaluation_outputs_are_the_programs(workload):
    cell = small_cell(workload)
    path = make_path(cell, CPU, 2**31 + 77)
    model = path.build_model().eval()
    tables, dense = path.reference_weights()
    batch = zipf_batch(path.layout, 16, 5, 1.2)
    with torch.no_grad():
        out = model(tensors(batch, CPU))
        feats, _ = pooled_features(path.layout, tables, tensors(batch, CPU))
        ref = path.ref.vectors(dense, feats, path.layout, path.args, False,
                               Precision("float32"))
    for k, v in ref.items():
        np.testing.assert_allclose(out[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("workload", ["dssm_recall-train_zipf", "dcn_criteo-train_zipf"])
def test_first_training_step_is_the_programs(workload):
    path = make_path(small_cell(workload), CPU, 2**31 + 78)
    path.setup()
    program = path.program
    ref = path.reference("float32")
    assert abs(program["loss"][0] - ref["loss"][0]) <= 1e-6 * abs(ref["loss"][0])
    for k, v in ref["grad"].items():
        if not k.startswith("table"):
            assert abs(program["grad"][k] - v) <= 1e-5 * v, k


def test_rowwise_adagrad_is_the_programs_sparse_set_update():
    from recommendflow_tpu_torch.train.optimizers import (init_accumulator,
                                                          split_table_update)
    gen = torch.Generator().manual_seed(3)
    table = (torch.rand((64, 32), generator=gen) - 0.5).to(torch.bfloat16)   # P = 8
    stored = table.view(8, 256)
    ids = torch.tensor([1, 5, 5, 9, 40, 41, 63, 1])
    g = torch.randn((8, 32), generator=gen)
    # the program: stored rows and their (duplicate) row gradients
    p_acc = init_accumulator(stored)
    wide = torch.zeros((8, 256))
    for i, r in enumerate(ids.tolist()):
        wide[i, (r % 8) * 32:(r % 8 + 1) * 32] = g[i]
    p_table = stored.clone()
    split_table_update(p_table, p_acc, (ids // 8).to(torch.int32), wide,
                       lr=0.03, strategy="sparse_set")
    # the reference: logical rows' summed gradients -> stored rows
    rows = Rows(table, ids, grad=True)
    (rows.values * 0).sum().backward()
    rows.values.grad = torch.zeros_like(rows.values).index_add_(
        0, torch.unique(ids, return_inverse=True)[1], g)
    lay = type("L", (), {"groups": {32: type("G", (), {"pack": 8})()}})()
    sids, sg = stored_row_grads(lay, 32, rows)
    acc = torch.full((8,), 0.1)
    r_table = table.clone()
    rowwise_adagrad(r_table, acc, 8, sids, sg, 0.03, 1e-10)
    assert torch.equal(r_table.view(8, 256), p_table)
    torch.testing.assert_close(acc, p_acc[:, 0], rtol=1e-6, atol=0)


def test_exact_top_k_is_the_searchers():
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    gen = torch.Generator().manual_seed(4)
    items = torch.randn((4096, 16), generator=gen)
    q = torch.randn((8, 16), generator=gen)
    s = FlatSearcher(16, metric="cos", device="cpu").train(items.numpy())
    _, scores, idx = s.search(q.numpy(), topk=20)
    ref = exact_scores(normalize_rows(q), normalize_rows(items), Precision())
    top = torch.topk(ref, 20, dim=1)
    np.testing.assert_array_equal(idx, top.indices.numpy())
    np.testing.assert_allclose(scores, top.values.numpy(), atol=1e-6)
