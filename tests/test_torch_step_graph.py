"""The host logic of train/graphs.py (`StepGraph`) and ops/cuda/launches.py
on the CPU. The graphs themselves need a card (tests/test_torch_cuda.py:
replays against eager steps bitwise, launch counts through replays, a
capture that must fail); here CUDA's stream and graph objects are stand-ins
that record what StepGraph asks of them, so its bookkeeping is checked: a
signature's first call runs eagerly, its second is captured and replayed,
later ones replay; the capture's launch counts are taken back and each
replay adds them; a failed capture raises with the operation it reached;
`bind` and `reset` drop the graphs.
"""
import contextlib

import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch.ops.cuda import embedding_bag as kr
from recommendflow_tpu_torch.ops.cuda import launches
from recommendflow_tpu_torch.train import graphs


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay is recorded, not run."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def pool(self):
        return (7, 7)


@pytest.fixture
def fake_cuda(monkeypatch):
    """StepGraph on CPU tensors with CUDA's streams, graphs and allocator
    snapshot replaced by stand-ins; yields the capture log."""
    log = {"captures": 0}

    @contextlib.contextmanager
    def graph(g, stream=None):
        log["captures"] += 1
        yield

    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: Stream())
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: [
        {"segment_pool_id": (7, 7), "total_size": 3_000_000},
        {"segment_pool_id": (0, 0), "total_size": 5_000_000}])
    monkeypatch.setattr(graphs, "copy_in", lambda static, batch: [
        static[k].copy_(batch[k]) for k in static])
    saved = launches.snapshot()
    yield log
    launches.add(launches.difference(launches.snapshot(), saved), -1)


def _step_graph():
    g = graphs.StepGraph(torch.device("cuda"), "test step")
    g.device = torch.device("cpu")        # CPU buffers under the stand-ins
    return g


def _batch(rows=4, fill=1.0):
    return {"x": np.full((rows, 3), fill, np.float32),
            "ids": np.arange(rows, dtype=np.int32)}


def test_first_call_eager_second_captured_then_replayed(fake_cuda):
    calls = []

    def fn(batch):
        calls.append(float(batch["x"][0, 0]))
        kr.gather_rows.launches += 2        # what the wrappers count
        kr.gather_rows.launches_by_row_bytes[128] = \
            kr.gather_rows.launches_by_row_bytes.get(128, 0) + 2
        return {"y": batch["x"].sum()}

    g = _step_graph()
    before = launches.snapshot()
    out1 = g(fn, _batch(fill=1.0))
    assert g._entries == {}                 # no buffers kept for it
    out2 = g(fn, _batch(fill=2.0))
    out3 = g(fn, _batch(fill=3.0))
    # eager on the first, captured (fn traced once, on the second batch's
    # buffers) on the second, then replays
    assert calls == [1.0, 2.0] and fake_cuda["captures"] == 1
    assert float(out1["y"]) == 12.0 and out2 is out3
    entry, = g._entries.values()
    assert entry.graph.replays == 2 and entry.replays == 2
    assert float(entry.inputs["x"][0, 0]) == 3.0     # the last batch copied
    # 2 launches eagerly, 2 a replay; the capture's own 2 taken back
    got = launches.difference(launches.snapshot(), before)
    assert got["gather_rows"] == 6
    assert got["gather_rows_by_row_bytes"] == {128: 6}
    st, = g.stats()
    assert st["replays"] == 2 and st["launches_per_replay"] == 2
    assert st["pool_mb"] == 3.0 and st["capture_s"] >= 0
    # another shape is another graph, from its own eager call
    g(fn, _batch(rows=2, fill=5.0))
    assert calls[-1] == 5.0 and fake_cuda["captures"] == 1
    assert len(g._entries) == 1 and len(g._seen) == 2


def test_bind_and_reset_drop_the_graphs(fake_cuda):
    g = _step_graph()
    fn = lambda b: {"y": b["x"].sum()}     # noqa: E731
    a, b = object(), object()
    g.bind(a)
    g(fn, _batch())
    g(fn, _batch())
    assert len(g.stats()) == 1
    g.bind(a)                               # the same owner keeps them
    assert len(g.stats()) == 1
    g.bind(b)                               # another drops them
    assert g._entries == {} and g._seen == set()
    g(fn, _batch())
    g(fn, _batch())
    g.reset()
    assert g._entries == {} and fake_cuda["captures"] == 2


def test_a_failed_capture_raises_with_the_operation(fake_cuda):
    state = {"calls": 0}

    def fn(batch):
        state["calls"] += 1
        y = torch.mul(batch["x"], 2.0)
        if state["calls"] == 2:             # inside the capture
            kr.gather_rows.launches += 1
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return {"y": y}

    g = _step_graph()
    g(fn, _batch())
    before = launches.snapshot()
    with pytest.raises(RuntimeError, match=r"test step: capturing a CUDA "
                       r"graph failed at aten\.mul\.Tensor: RuntimeError: "
                       r"operation not permitted"):
        g(fn, _batch())
    # the failed capture's counts were taken back; nothing falls back
    assert launches.difference(launches.snapshot(), before)["gather_rows"] == 0
    assert state["calls"] == 2


def test_step_graph_needs_a_card():
    with pytest.raises(ValueError, match="need a card"):
        graphs.StepGraph(torch.device("cpu"))
    t = tp.demo_trainer({"tower_units": [64, 32]})
    assert t.graph_stats() == {}
    with pytest.raises(ValueError, match="need a card"):
        t.graph("train")


def test_signature_and_as_tensor():
    b = _batch()
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    sig = graphs.signature({k: graphs.as_tensor(v) for k, v in b.items()})
    assert sig == graphs.signature(t)
    assert sig != graphs.signature({**t, "x": t["x"].double()})
    assert sig != graphs.signature({**t, "x": t["x"][:2]})
    assert graphs.as_tensor(t["x"]) is t["x"]


def test_last_op_and_innermost_error():
    with graphs._LastOp() as last:
        torch.ones(2) + 1
    assert last.last == "aten.add.Tensor"
    try:
        try:
            raise KeyError("first")
        except KeyError:
            raise RuntimeError("second")
    except RuntimeError as e:
        assert isinstance(graphs._innermost(e), KeyError)


def test_launch_count_records():
    saved = launches.snapshot()
    try:
        delta = {"gather_rows": 3, "flash_attention": 1,
                 "gather_rows_by_row_bytes": {64: 3},
                 "grouped_score_max_by_dtype": {}}
        launches.add(delta, times=2)
        got = launches.difference(launches.snapshot(), saved)
        assert got["gather_rows"] == 6 and got["flash_attention"] == 2
        assert got["gather_rows_by_row_bytes"] == {64: 6}
        assert launches.total(delta) == 4
        launches.add(delta, times=-2)
        assert launches.difference(launches.snapshot(), saved) == {
            **{k: 0 for k in launches.COUNTERS},
            "gather_rows_by_row_bytes": {}, "grouped_score_max_by_dtype": {}}
    finally:
        launches.add(launches.difference(launches.snapshot(), saved), -1)


def test_eval_outputs_on_the_cpu_are_the_models():
    from recommendflow_tpu_torch.train.trainer import eval_outputs, to_device
    t = tp.demo_trainer({"tower_units": [64, 32]})
    batch = tp.demo_batches(1, seed=3).batches[0]
    t.model.eval()
    with torch.no_grad():
        got = eval_outputs(t.model, batch, torch.device("cpu"))
        want = t.model(to_device(batch, torch.device("cpu")))
    assert sorted(got) == sorted(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
