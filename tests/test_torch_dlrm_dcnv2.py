"""DLRM-DCNv2 (`models/ranking/dlrm.py:DlrmDcnV2`, `ops/interactions.py:
LowRankCrossNet`) against the plain float32 model of tests/_plain_dlrm_dcnv2.py,
on the CPU at a small size: MLPerf's 26 sparse fields with their multi-hot
sizes (bags of 1 to 100 ids) and 13 dense fields at tiny cardinalities,
dim 8, x0 27 x 8 wide, cross rank 4 (tests/_dlrm_dcnv2_tasks.py), on
seeded random weights copied into both.

Tolerances. The port and the plain model do the same float32 arithmetic in
another order (the embed pass's fused gather and pooling, the matrix
products' blocking): forward values within rtol 1e-5; gradients and the
weights after three steps within 1e-4 of each tensor's largest entry,
three multiplicative cross layers and Adam's division by a root of the
second moment amplifying those roundings. A bf16 table's gradient reaches
the gather in bf16 id by id and its sum is rounded once more (the scatter
into the table's dtype): within 2^-7 (bf16's unit roundoff, twice) of its
occurrences' summed sizes beside float32's 1e-4 of the largest entry.
"""
import numpy as np
import pytest
import torch

import _dlrm_dcnv2_tasks as dt
import _plain_dlrm_dcnv2 as plain
import _torch_dist
from recommendflow_tpu_torch.utils import profiling

torch.set_num_threads(1)

ARCH = (len(dt.ARCH["bottom_units"]), dt.ARCH["cross_layers"],
        len(dt.ARCH["top_units"]))
LR, TABLE_LR = 1e-3, 0.03


@pytest.fixture(scope="module")
def pool2(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 2)


def _randomize(model, seed):
    """Every dense weight N(0, 1/fan_in), every bias N(0, 0.1^2): no
    weight left at zero, so every term of the equation moves the output."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "table" in name:
                continue
            x = torch.randn(p.shape, generator=gen)
            p.copy_(x / p.shape[-1] ** 0.5 if p.dim() == 2 else 0.1 * x)


def _plain_params(model):
    named = dict(model.named_parameters())
    p = {}
    for i in range(ARCH[0]):
        for part in ("weight", "bias"):
            p[f"bottom{i}.{part}"] = named[f"bottom.Dense_{i}.{part}"]
    for i in range(ARCH[1]):
        p[f"cross{i}.V"] = named[f"cross.V_{i}.weight"]
        p[f"cross{i}.U"] = named[f"cross.U_{i}.weight"]
        p[f"cross{i}.bias"] = named[f"cross.U_{i}.bias"]
    for i in range(ARCH[2]):
        for part in ("weight", "bias"):
            p[f"top{i}.{part}"] = named[f"top.Dense_{i}.{part}"]
    p["head.weight"], p["head.bias"] = named["head.weight"], named["head.bias"]
    return {k: v.detach().clone() for k, v in p.items()}


def _port_name(name):
    layer, part = name.split(".")
    for prefix in ("bottom", "top"):
        if layer.startswith(prefix):
            return f"{prefix}.Dense_{layer[len(prefix):]}.{part}"
    if layer.startswith("cross"):
        i = layer[5:]
        return {"V": f"cross.V_{i}.weight", "U": f"cross.U_{i}.weight",
                "bias": f"cross.U_{i}.bias"}[part]
    return name


def _offsets(model):
    group = model.schema.groups[dt.DIM]
    return [group.offset_of(n, 0) for n in dt.SPARSE]


def _table(model):
    return getattr(model.embedder, f"table_dim{dt.DIM}")


def _plain_logits(model, batch):
    t = _table(model).detach().view(-1, dt.DIM).float()
    with plain.exact_float32():
        return plain.logits(_plain_params(model),
                            plain.gathered(t, _offsets(model), dt.SPARSE, batch),
                            dt.SPARSE, dt.DENSE, batch, *ARCH)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().double().numpy()
    return np.asarray(x, np.float64)


def _close(a, b, rel, what):
    a, b = _np(a), _np(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------- the cross

@pytest.mark.parametrize("width,rank,layers", [(27 * 8, 4, 3), (40, 8, 1)])
def test_low_rank_cross_is_its_equation(width, rank, layers):
    from recommendflow_tpu_torch.ops.interactions import LowRankCrossNet
    gen = torch.Generator().manual_seed(width + rank)
    net = LowRankCrossNet(width, layers, rank, device="cpu")
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x0 = torch.randn(5, width, generator=gen)
    x = x0.double()
    for i in range(layers):
        v = getattr(net, f"V_{i}").weight.double()
        u = getattr(net, f"U_{i}")
        x = x0.double() * (u.weight.double() @ (v @ x.T) + u.bias.double()[:, None]).T + x
    _close(net(x0).detach(), x, 1e-5, "cross")
    with torch.no_grad():
        for i in range(layers):
            getattr(net, f"U_{i}").weight.zero_()
    out, want = net(x0).detach(), x0.clone()
    for i in range(layers):
        want = x0 * getattr(net, f"U_{i}").bias.detach() + want
    _close(out, want, 1e-6, "cross with U = 0")


def test_cross_markers_in_order(monkeypatch):
    from recommendflow_tpu_torch.ops import interactions
    marks = []
    monkeypatch.setattr(interactions, "mark_region",
                        lambda device, region: marks.append(region))
    net = interactions.LowRankCrossNet(12, 2, 3, device="cpu")
    x0 = torch.randn(4, 12, requires_grad=True)
    with torch.no_grad():
        net(x0)
    assert marks == []
    net(x0 * 2.0).sum().backward()
    assert marks == ["cross_forward", "cross_forward_end", "cross_backward",
                     "cross_backward_end"]


def test_mark_region_does_nothing_on_the_cpu(monkeypatch):
    from recommendflow_tpu_torch.ops.cuda import span_marker
    monkeypatch.setattr(span_marker, "launch_region",
                        lambda *a: pytest.fail("a marker launched on the CPU"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for region in span_marker.REGIONS:
            profiling.mark_region(torch.device("cpu"), region)


# ------------------------------------------------------------- the model

def test_built_from_the_configuration():
    from recommendflow_tpu_torch.models.ranking import DlrmDcnV2
    model = dt.build()
    assert isinstance(model, DlrmDcnV2) and model.row_injection
    assert model.cross.V_0.weight.shape == (4, 27 * dt.DIM)
    assert model.cross.U_2.weight.shape == (27 * dt.DIM, 4)
    assert [model.top.Dense_0.in_features, model.head.in_features] == [216, 8]
    assert sum(s.max_len for s in model.schema.sparse_slots()) == 214
    with pytest.raises(ValueError, match="bottom MLP ends"):
        DlrmDcnV2(model.conf, bottom_units=[16, 4], device="cpu")


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_logits_loss_and_every_gradient(table_dtype):
    model = dt.build(table_dtype, seed=3)
    _randomize(model, 4)
    batch = _tensors(dt.make_batch(16, seed=7))
    model.eval()
    with torch.no_grad():
        out = model(batch)
    want = _plain_logits(model, batch)
    _close(out["logit"], want, 1e-5, "logits")
    np.testing.assert_array_equal(out["label"].numpy(), batch["label"].numpy())
    model.train()
    loss, aux = model(batch)
    loss.backward()
    p = {k: v.requires_grad_() for k, v in _plain_params(model).items()}
    t = _table(model).detach().view(-1, dt.DIM).float().requires_grad_()
    offsets = _offsets(model)
    rows = [r.detach().requires_grad_()
            for r in plain.gathered(t, offsets, dt.SPARSE, batch)]
    with plain.exact_float32():
        ref = plain.bce(plain.logits(p, rows, dt.SPARSE, dt.DENSE, batch, *ARCH),
                        batch["label"])
    ref.backward()
    loss, ref = float(loss.detach()), float(ref.detach())
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    named = dict(model.named_parameters())
    for k, v in p.items():
        _close(named[_port_name(k)].grad, v.grad, 1e-4, k)
    # each row's gradient: its occurrences' summed; and the sum of their sizes
    want, size = torch.zeros_like(t), torch.zeros_like(t)
    for n, off, r in zip(dt.SPARSE, offsets, rows):
        ids = batch[n].long().reshape(-1) + off
        want.index_add_(0, ids, r.grad.reshape(-1, dt.DIM))
        size.index_add_(0, ids, r.grad.reshape(-1, dt.DIM).abs())
    g = _table(model).grad.view(-1, dt.DIM).float().numpy()
    want, size = want.numpy(), size.numpy()
    touched = size.sum(axis=1) > 0
    assert touched.sum() > 100
    np.testing.assert_array_equal(g[~touched], 0)
    if table_dtype == "float32":
        _close(g, want, 1e-4, "row gradients")
    else:
        # each occurrence's gradient reaches the gather in bf16 (the gather's
        # output dtype), then the sum is rounded once more: bf16's unit
        # roundoff 2^-8 twice over the occurrences' sizes, beside float32's
        # 1e-4 of the largest
        tol = 2.0 ** -7 * size + 1e-4 * np.abs(want).max()
        assert np.all(np.abs(g - want) <= tol), "bf16 row gradients"


def test_uneven_bags_with_pads_pool_as_the_plain_model():
    model = dt.build("bfloat16", seed=5)
    batch = dt.make_batch(6, seed=11)
    rng = np.random.default_rng(12)
    for n in dt.SPARSE:           # pads leading, inside, trailing, all pad
        ids = batch[n]
        L = ids.shape[-1]
        ids[:] = rng.integers(1, 6, size=ids.shape)
        ids[0, 0, 0] = 0
        ids[1, 0, L // 2] = 0
        ids[2, 0, -1] = 0
        ids[3, 0, :] = 0
    tb = _tensors(batch)
    with torch.no_grad():
        feats = model.embedder(tb)
    table = _table(model).detach().view(-1, dt.DIM)
    want = plain.pooled(plain.gathered(table, _offsets(model), dt.SPARSE, tb),
                        dt.SPARSE, tb)
    for n, w in zip(dt.SPARSE, want):
        _close(feats[n], w, 1e-6, n)
        assert float(feats[n][3].abs().sum()) == 0.0
    _close(model.eval()(tb)["logit"].detach(), _plain_logits(model, tb), 1e-5,
           "logits")


def _plain_steps(model, batches):
    t = _table(model).detach()
    pack = t.shape[1] // dt.DIM
    return plain.train_steps(_plain_params(model), t.view(-1, dt.DIM),
                             _offsets(model), dt.SPARSE, dt.DENSE, "label",
                             [_tensors(b) for b in batches], ARCH, pack, LR,
                             TABLE_LR)


def test_fit_three_steps_match_the_plain_model():
    from recommendflow_tpu_torch.train.trainer import Trainer
    model = dt.build(seed=1)
    _randomize(model, 2)
    batches = [dt.make_batch(16, seed=20 + i) for i in range(3)]
    losses, p, table = _plain_steps(model, batches)
    trainer = Trainer(model, learning_rate=LR, table_learning_rate=TABLE_LR,
                      device="cpu")
    out = trainer.fit(batches, verbose=False)
    assert out["state"].step == 3
    assert abs(out["history"][0]["loss"] - np.mean(losses)) <= 1e-5 * np.mean(losses)
    named = dict(model.named_parameters())
    for k, v in p.items():
        _close(named[_port_name(k)].detach(), v, 1e-4, k)
    _close(_table(model).detach().view(-1, dt.DIM), table, 1e-4, "table")
    pred = trainer.predict(out["state"], batches[:1])
    _close(pred["logit"], _plain_logits(model, _tensors(batches[0])), 1e-5,
           "predict")
    assert 0.0 <= trainer.evaluate(out["state"], batches)["val_auc"] <= 1.0


def test_mesh_of_two_matches_one_process(pool2):
    from recommendflow_tpu_torch.train.trainer import Trainer
    model = dt.build(seed=1)
    _randomize(model, 2)
    dense = {k: v.detach().numpy().copy() for k, v in model.named_parameters()
             if "table" not in k}
    table = _table(model).detach().numpy().copy()
    batches = [dt.make_batch(16, seed=30 + i) for i in range(3)]
    out = Trainer(model, learning_rate=LR, table_learning_rate=TABLE_LR,
                  device="cpu").fit(batches, verbose=False)
    ranks = pool2.run(dt.mesh_fit, dense, table, batches, LR, TABLE_LR)
    whole = _table(model).shape[0]
    for loss, params, t, block_rows in ranks:
        assert block_rows * 2 == whole            # the table is row-sharded
        assert abs(loss - out["history"][0]["loss"]) <= 1e-5 * loss
        for k, v in params.items():
            _close(v, dict(model.named_parameters())[k].detach(), 1e-4, k)
        _close(t, _table(model).detach(), 1e-4, "table")


class _Mesh:
    """A stand-in for a mesh of `n` ranks seen from rank `r`: what the
    sharding rules, `init_group_block` and `mark_row_shard` ask of one."""

    def __init__(self, n, r):
        self.n, self.r = n, r

    def size(self, axis="dp"):
        return self.n

    def rank(self, axis="dp"):
        return self.r


@pytest.mark.parametrize("built", ["whole", "block", "wrong"])
def test_mark_row_shard_keeps_a_block_built_alone(built):
    from recommendflow_tpu_torch.parallel.sharded_embedding import \
        mark_row_shard
    whole = torch.arange(16 * 3, dtype=torch.float32).view(16, 3)
    rows = {"whole": whole, "block": whole[8:12], "wrong": whole[:5]}[built]
    p = torch.nn.Parameter(rows.clone())
    if built != "whole":
        p.whole_rows = 16
    if built == "wrong":
        with pytest.raises(ValueError, match="neither the whole"):
            mark_row_shard(p, _Mesh(4, 2), "dp")
        assert getattr(p, "row_shard", None) is None
        return
    mark_row_shard(p, _Mesh(4, 2), "dp")
    assert torch.equal(p.data, whole[8:12])
    assert (p.row_shard.total_rows, p.row_shard.start, p.row_shard.rows) == \
        (16, 8, 4)


def test_a_model_built_at_a_block_needs_a_trainer_that_shards_it():
    from recommendflow_tpu_torch.ops.embedding import (init_group_block,
                                                       table_shape)
    from recommendflow_tpu_torch.train.trainer import Trainer
    model = dt.build(mesh=_Mesh(2, 1), seed=4)
    t, group = _table(model), model.schema.groups[dt.DIM]
    whole = table_shape(group, "float32")[0]
    assert t.whole_rows == whole and t.shape[0] * 2 == whole
    assert getattr(t, "row_shard", None) is None        # the Trainer marks it
    gen = torch.Generator().manual_seed(4)
    assert torch.equal(t.detach(),
                       init_group_block(gen, group, 1, 2, device="cpu"))
    with pytest.raises(ValueError, match="does not row-shard"):
        Trainer(model, device="cpu").fit([dt.make_batch(4, seed=1)],
                                         verbose=False)


# ------------------------------------------------------------- spans

def test_model_spans_record_only_under_a_profiler():
    model = dt.build(seed=2).train()
    batch = _tensors(dt.make_batch(4, seed=3))
    profiling._SPANS.clear()
    model(batch)
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        loss, _ = model(batch)
    names = [s.name for s in profiling.spans()]
    assert names == ["dlrm.bottom", "dlrm.interaction", "dlrm.top"]


def test_lookup_spans_count_the_exchange(pool2):
    """Every slot is sum-pooled, so the lookup takes the pooled form:
    forward, the ids' all-gather and the reduce-scatter's input, each id's
    row in the table's dtype (f32 here); backward, the all-gather of the
    pooled gradient, one f32 row a bag of the global batch."""
    rows = 3
    for spans in pool2.run(dt.lookup_spans, rows):
        assert [n for n, _ in spans] == ["shard.lookup", "shard.lookup_grad"]
        ids = 2 * rows * sum(dt.MULTI_HOT)        # the global batch's ids
        bags = 2 * rows * len(dt.SPARSE)          # and its bags
        assert spans[0][1] == {"ids": ids, "bags": bags,
                               "exchange_bytes": ids * 4 + ids * dt.DIM * 4}
        assert spans[1][1] == {"exchange_bytes": bags * dt.DIM * 4}
