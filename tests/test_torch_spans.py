"""The span recorder of utils/profiling.py and its spans in the program, on
the CPU.

A span records only while a torch profiler runs: with none, a site returns
one shared no-op and nothing is kept. Under a CPU profiler spans nest with
their parent, thread and counts, each encloses its own range in the host's
trace (one offset puts the host's clock on the trace's), and fit, predict, FlatSearcher.search and ServingModel.predict record the
spans PERF.md's table names: one `fit.step` per step, one top-level span
per request. The phase markers do nothing on the CPU.
"""
import json
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch.utils import profiling
from recommendflow_tpu_torch.utils.profiling import span, spanned, spans

CPU = torch.profiler.ProfilerActivity.CPU


@pytest.fixture
def recorded():
    """The spans recorded inside the test, under a CPU profiler: a callable
    that returns them once the profiler has stopped."""
    profiling._SPANS.clear()
    prof = torch.profiler.profile(activities=[CPU])
    prof.start()
    state = {"prof": prof}

    def stop():
        if state["prof"] is not None:
            state["prof"].stop()
            state["prof"] = None
        return spans()
    stop.prof = prof
    yield stop
    stop()
    profiling._SPANS.clear()


def _names(recorded_spans):
    return Counter(s.name for s in recorded_spans)


def _roots(recorded_spans):
    """{span id: the id of the top-level span it lies in}, by its parents."""
    by_id = {s.id: s for s in recorded_spans}

    def root(s):
        while s.parent is not None:
            s = by_id[s.parent]
        return s.id
    return {s.id: root(s) for s in recorded_spans}


def test_without_a_profiler_nothing_is_recorded():
    profiling._SPANS.clear()
    assert not profiling.recording()
    site = span("outer")
    assert site is span("other") is profiling._NO_SPAN
    with site as s:
        s.add(rows=4)
        s.mark()
        with span("inner"):
            pass
    assert list(spanned(iter([1, 2]), "each")) == [1, 2]
    assert spans() == []


def test_nested_spans_record_parent_thread_and_counts(recorded):
    with span("step") as outer:
        outer.add(rows=8)
        with span("step.a"):
            with span("step.a.x") as x:
                x.add(k=2)
        with span("step.b"):
            pass
        outer.add(steps=1)
        outer.mark()
    with span("next"):
        pass
    got = {s.name: s for s in recorded()}
    assert set(got) == {"step", "step.a", "step.a.x", "step.b", "next"}
    step = got["step"]
    assert step.parent is None
    assert step.counts == {"rows": 8, "steps": 1}
    assert got["step.a"].parent == step.id and got["step.b"].parent == step.id
    assert got["step.a.x"].parent == got["step.a"].id
    assert got["step.a.x"].counts == {"k": 2}
    # a mark is a time inside its span; a span not marked has none
    assert got["step.b"].end_ns <= step.mark_ns <= step.end_ns
    assert got["step.a"].mark_ns is None
    # the spans of one step reach the top-level span by their parents
    roots = _roots(got.values())
    assert {roots[got[n].id] for n in ("step.a", "step.a.x", "step.b")} \
        == {step.id}
    assert got["next"].parent is None and roots[got["next"].id] != step.id
    assert got["next"].counts == got["step.a"].counts == {}
    assert {s.thread for s in got.values()} == {threading.get_ident()}
    for inner, outer_ in (("step.a", "step"), ("step.a.x", "step.a"),
                          ("step.b", "step")):
        assert got[outer_].start_ns <= got[inner].start_ns
        assert got[inner].end_ns <= got[outer_].end_ns
    assert got["step.a"].end_ns <= got["step.b"].start_ns
    assert [s.name for s in spans()] == ["step", "step.a", "step.a.x",
                                         "step.b", "next"]     # by start


def test_each_span_encloses_its_own_range_in_the_trace(recorded, tmp_path):
    for i in range(5):
        with span("outer"):
            torch.ones(64).sum()
            with span("inner"):
                torch.ones(64).mul(2)
    recorded_spans = recorded()
    path = str(tmp_path / "trace.json")
    recorded.prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") in ("user_annotation", "cpu_op")
                  and e.get("name") in ("outer", "inner")]
    assert _names(recorded_spans) == Counter(e["name"] for e in events) \
        == {"outer": 5, "inner": 5}
    # one offset of the host's clock onto the trace's puts every event
    # inside its own span: no event starts before its span's start or ends
    # after its span's end, under the same offset
    lo, hi = -np.inf, np.inf
    for name in ("outer", "inner"):
        ss = sorted((s for s in recorded_spans if s.name == name),
                    key=lambda s: s.start_ns)
        es = sorted((e for e in events if e["name"] == name),
                    key=lambda e: e["ts"])
        for s, e in zip(ss, es):
            ts, te = 1e3 * float(e["ts"]), 1e3 * (float(e["ts"]) + float(e["dur"]))
            hi = min(hi, ts - s.start_ns)
            lo = max(lo, te - s.end_ns)
    assert lo <= hi + 1e3          # within the trace's 1 ns rounding


def test_spans_of_another_thread_are_its_own(recorded):
    from recommendflow_tpu_torch.data.pipeline import prefetch
    with span("consumer"):
        got = list(prefetch(iter(range(4))))
    assert got == [0, 1, 2, 3]
    recorded_spans = recorded()
    produce = [s for s in recorded_spans if s.name == "prefetch.produce"]
    # four items and the end of the iterator, each drawn under a span
    assert len(produce) == 5
    (consumer,) = [s for s in recorded_spans if s.name == "consumer"]
    assert {s.thread for s in produce} != {consumer.thread}
    assert all(s.parent is None for s in produce)


def test_threads_record_their_spans_apart(recorded):
    """Sixteen threads record nested spans at once, switching every
    microsecond: none is lost, ids are unique, and each inner span's
    parent is its own thread's outer span."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for i in range(100):
            with span("outer") as outer:
                outer.add(k=k, i=i)
                with span("inner") as inner:
                    inner.add(k=k, i=i)
    threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = recorded()
    assert len(got) == 16 * 100 * 2
    assert len({s.id for s in got}) == len(got)
    outer = {s.id: s for s in got if s.name == "outer"}
    for s in got:
        if s.name == "inner":
            parent = outer[s.parent]
            assert parent.parent is None
            assert (parent.thread, parent.counts) == (s.thread, s.counts)


def test_spanned_closes_what_it_draws_from(recorded):
    closed = []

    def source():
        try:
            yield from range(10)
        finally:
            closed.append(True)
    it = spanned(source(), "draw")
    assert [next(it), next(it)] == [0, 1]
    it.close()
    assert closed == [True]
    assert _names(recorded())["draw"] == 2


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_fit_records_one_fit_step_per_step(recorded, scan_steps):
    trainer = tp.demo_trainer({"tower_units": [32, 16]})
    r = trainer.fit(tp.demo_batches(5, seed=70), epochs=1, verbose=False,
                    scan_steps=scan_steps)
    assert r["state"].step == 5
    recorded_spans = recorded()
    names = _names(recorded_spans)
    assert names["fit.step"] == names["fit.host_step"] == 5
    # each item from prefetch, and its end: 5 single steps, or 2 stacks of
    # 2 and the tail of 1
    assert names["fit.next"] == (6 if scan_steps == 1 else 4)
    assert names["fit.stack"] == (0 if scan_steps == 1 else 2)
    stacks = [s for s in recorded_spans if s.name == "fit.stack"]
    assert [s.counts for s in stacks] == [{"steps": 2}] * len(stacks)
    assert names["fit.pin"] == len(stacks)
    steps = [s for s in recorded_spans if s.name == "fit.step"]
    assert all(s.counts == {} for s in steps)
    by_id = {s.id: s for s in recorded_spans}
    for s in recorded_spans:
        if s.name == "fit.host_step":
            assert by_id[s.parent].name == "fit.step"
    # every span on fit's thread lies inside a top-level one of fit
    tops = {"fit.step", "fit.stack", "fit.next", "fit.metrics"}
    fit_thread = steps[0].thread
    roots = _roots(recorded_spans)
    assert {by_id[roots[s.id]].name for s in recorded_spans
            if s.thread == fit_thread} <= tops


def test_mark_phase_does_nothing_on_the_cpu(recorded, monkeypatch):
    from recommendflow_tpu_torch.ops.cuda import span_marker
    monkeypatch.setattr(span_marker, "launch_marker",
                        lambda *a: pytest.fail("a marker launched on the CPU"))
    for phase in span_marker.PHASES:
        profiling.mark_phase(torch.device("cpu"), phase)
    trainer = tp.demo_trainer({"tower_units": [32, 16]})
    st = trainer.init_state(tp.demo_batches(1, seed=1).batches[0])
    trainer.train_steps(st, tp.demo_batches(2, seed=2).batches)
    assert _names(recorded())["fit.step"] == 2


def test_predict_records_its_spans(recorded):
    trainer = tp.demo_trainer({"tower_units": [32, 16]})
    st = trainer.init_state(tp.demo_batches(1, seed=1).batches[0])
    out = trainer.predict(st, tp.demo_batches(3, seed=3, batch=16))
    assert len(out["user"]) == 48
    recorded_spans = recorded()
    names = _names(recorded_spans)
    assert names["predict"] == names["predict.fetch"] == 1
    assert names["predict.prefetch"] == 4        # three batches and the end
    (top,) = [s for s in recorded_spans if s.name == "predict"]
    assert all(s.parent == top.id for s in recorded_spans
               if s.name in ("predict.prefetch", "predict.fetch"))


def test_flat_search_records_its_spans(recorded):
    from recommendflow_tpu_torch.retrieval.flat import FlatSearcher
    rng = np.random.default_rng(0)
    searcher = FlatSearcher(8, "cos", device="cpu").train(
        rng.standard_normal((300, 8)).astype(np.float32),
        items=np.arange(300) + 1000)
    searcher.query_block = 4
    items, scores, idx = searcher.search(
        rng.standard_normal((10, 8)).astype(np.float32), topk=5)
    assert items.shape == scores.shape == idx.shape == (10, 5)
    recorded_spans = recorded()
    names = _names(recorded_spans)
    assert names["search"] == names["search.normalise"] == 1
    assert names["search.copy_in"] == names["search.launch"] == 3   # 4+4+2
    assert names["search.fetch"] == names["search.items"] == 1
    (top,) = [s for s in recorded_spans if s.name == "search"]
    assert all(s.parent == top.id for s in recorded_spans if s is not top)


def test_serving_model_records_its_spans(recorded, tmp_path):
    from recommendflow_tpu_torch.export import ServingModel, export_model
    trainer = tp.demo_trainer({"tower_units": [32, 16]})
    model = trainer.model.eval()
    batch = tp.demo_batches(1, seed=4, batch=16).batches[0]
    labels = [k for k in model.schema.label_names if k in batch]
    serve = {k: v for k, v in batch.items() if k not in labels}
    path = export_model(model, serve, str(tmp_path / "model"),
                        constants={k: np.zeros_like(batch[k]) for k in labels})
    serving = ServingModel.load(path, device="cpu")
    profiling._SPANS.clear()
    for _ in range(3):
        serving.predict(serve)
    recorded_spans = recorded()
    names = _names(recorded_spans)
    assert {n: names[n] for n in ("serve.predict", "serve.check", "serve.cast",
                                  "serve.fetch")} == dict.fromkeys(
        ("serve.predict", "serve.check", "serve.cast", "serve.fetch"), 3)
    tops = [s for s in recorded_spans if s.name == "serve.predict"]
    assert set(_roots(recorded_spans).values()) == {s.id for s in tops}


def test_the_newest_spans_are_kept(recorded, monkeypatch):
    from collections import deque
    assert profiling._SPANS.maxlen == profiling.MAX_SPANS
    monkeypatch.setattr(profiling, "_SPANS", deque(maxlen=4))
    for i in range(10):
        with span("each") as each:
            each.add(i=i)
    assert [s.counts["i"] for s in recorded()] == [6, 7, 8, 9]
