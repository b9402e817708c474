"""The split planner (Trainer(split_strategy="auto"), the default): each
split table takes the strategy that the card's cost model
(train/trainer.py:split_costs, plan_strategy) finds cheaper for its bytes
and the sample batch's ids; explicit strategies are kept whatever the
costs."""
import pytest

import _torch_parity as tp
from recommendflow_tpu_torch.train import trainer as tr

RANK_CONF = f"{tp.ROOT}/conf/demo_ranking.yaml"
BENCH_RANK_CONF = f"{tp.ROOT}/conf/bench_ranking.yaml"


def _dcn(conf=RANK_CONF):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    from recommendflow_tpu_torch.models.ranking.dcn import Dcn
    c = Configuration(conf)
    return Dcn(c, hidden_units=[16], device="cpu"), \
        synthetic_batch(compile_schema(c.features), 256, seed=0)


def test_cost_model_picks_by_bytes_and_ids():
    # the split shapes of the shipped configs: a small table that many ids
    # touch, and the two bench tables (stored bf16) with one batch's ids
    plan = tr.plan_strategy
    assert plan(40_422 * 16 * 4, 256 * 9) == "dense"                 # demo
    assert plan(1_505_024 * 256 * 2, 87_040) == "sparse_set"         # recall
    assert plan(4_875_008 * 256 * 2, 106_496) == "sparse_set"        # ranking
    dense, sparse = tr.split_costs(1 << 30, 100_000)
    assert dense == pytest.approx(tr.DENSE_S_PER_BYTE * (1 << 30))
    assert sparse == pytest.approx(tr.SPARSE_S_PER_ID * 100_000
                                   + tr.SPARSE_FIXED_S)
    # the crossing: the table size at which both cost the same
    n = 50_000
    even = (tr.SPARSE_S_PER_ID * n + tr.SPARSE_FIXED_S) / tr.DENSE_S_PER_BYTE
    assert plan(int(even * 0.9), n) == "dense"
    assert plan(int(even * 1.1), n) == "sparse_set"


def test_auto_is_the_default_and_plans_per_table(monkeypatch):
    model, batch = _dcn()
    t = tr.Trainer(model, device="cpu")
    assert t.split_strategy == "auto"
    table = tr.table_params(model)[16]
    nbytes = table.numel() * table.element_size()
    n_ids = sum(batch[s.name].size for s in (model.schema.slots[n] for n in
                                               model.schema.order)
                if s.kind == "sparse")
    assert t.plan(batch) == [16]
    assert tr.plan_strategy(nbytes, n_ids) == "dense"
    assert t._split_dims == {16: "dense"}
    # a card on which the table's passes cost more than its ids
    monkeypatch.setattr(tr, "DENSE_S_PER_BYTE",
                        10 * tr.split_costs(0, n_ids)[1] / nbytes)
    t.plan(batch)
    assert t._split_dims == {16: "sparse_set"}
    state, m = t.train_step(t.init_state(batch), batch)
    assert set(state.table_acc) == {"dim16"}


@pytest.mark.parametrize("strategy", ["dense", "sparse_set", "sparse"])
def test_explicit_strategies_are_kept(monkeypatch, strategy):
    model, batch = _dcn()
    for per_byte in (1.0, 0.0):         # dense dearer / cheaper than ids
        monkeypatch.setattr(tr, "DENSE_S_PER_BYTE", per_byte)
        t = tr.Trainer(model, split_strategy=strategy, device="cpu")
        t.plan(batch)
        assert t._split_dims == {16: strategy}


def test_dense_table_update_plans_no_split():
    model, batch = _dcn()
    t = tr.Trainer(model, table_update="dense", device="cpu")
    assert t.plan(batch) == [16] and t._split_dims == {}
