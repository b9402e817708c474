"""The readers of the program's spans (harness/spans.py and the metrics
that use it), against hand-made traces and hand-made spans with hand
counts, and None where the program has no recorder, recorded nothing, or
recorded spans that cannot be aligned or count other than the traced
units.

Training stretch (trace µs; the host's spans sit 1002 µs later on the
trace's clock once aligned: the first replay's launch starts as its span
does, the second's 3 µs after, so the least difference is 1002; each
span ends as its launch does, or later):

    launches  cudaMemcpyAsync 1000-1005, cudaGraphLaunch 1102-1106 and
              1605-1609, cudaStreamSynchronize 1950-2100
    device    a copy 1010-1020; per step (the second 500 later) markers
              gather 1110, forward 1130, backward 1200, optimizer 1300,
              table_update 1340, end 1400 (2 µs each) and kernels filling
              1112-1130 (gather_rows_kernel), 1132-1200, 1202-1300,
              1302-1340, 1342-1400
    spans     fit.next 1002-1050; fit.stack 1050-1902 (steps 2) holding
              fit.pin 1050-1062, fit.step 1092-1422 (graph.replay
              1102-1106) and fit.step 1592-1902 (graph.replay 1602-1612)

Busy [1010, 1020], [1110, 1402], [1610, 1902]: idle 10 + 90 + 208 + 198
= 506 µs in the window [1000, 2100], and 297 µs busy a step. Under
fit.next or fit.pin: 8 + 30 + 12 = 50 µs. Named by a span below the
top-level ones or under a runtime call: 10 + 46 + 8 + 150 = 214 µs, so
292 µs unattributed. Phases a step: gather 20, forward 70, backward 100,
optimizer 40, table_update 60 µs. An untraced step of 1 ms has 703 µs of
idle, 50/506 of it under the input spans.
"""
import math
import types

import pytest

from portbench.harness import spans as S
from portbench.harness.trace import TraceSummary
from portbench.tests.test_trace_and_metrics import (BATCH, PEAKS, Stub, layout,
                                                    on_mesh, reader, x)

MAIN, WORKER = 11, 22


def span(sid, name, start_us, end_us, parent=None, thread=MAIN, **counts):
    return types.SimpleNamespace(name=name, start_ns=int(start_us * 1000),
                                 end_ns=int(end_us * 1000), id=sid,
                                 parent=parent, thread=thread, counts=counts,
                                 mark_ns=None)


def step_events(at):
    marks = [("gather", 0), ("forward", 20), ("backward", 90), ("optimizer", 190),
             ("table_update", 230), ("end", 290)]
    kernels = [("void gather_rows_kernel<int>(...)", 2, 20),
               ("gemm_forward", 22, 90), ("gemm_backward", 92, 190),
               ("adam", 192, 230), ("radixSortKVInPlace", 232, 270),
               ("void scatter_add_rows_kernel(...)", 270, 290)]
    return [x(f"rf_span_{m}", "kernel", at + t, 2) for m, t in marks] + \
        [x(n, "kernel", at + a, b - a) for n, a, b in kernels]


TRAIN_EVENTS = [
    x("cudaMemcpyAsync", "cuda_runtime", 1000, 5),
    x("cudaGraphLaunch", "cuda_runtime", 1102, 4),
    x("cudaGraphLaunch", "cuda_runtime", 1605, 4),
    x("cudaStreamSynchronize", "cuda_runtime", 1950, 150),
    x("Memcpy HtoD", "gpu_memcpy", 1010, 10),
] + step_events(1110) + step_events(1610)

# host µs (trace µs - 1002)
TRAIN_SPANS = [
    span(1, "fit.next", 0, 48), span(2, "fit.stack", 48, 900, steps=2),
    span(3, "fit.pin", 48, 60, 2),
    span(4, "fit.step", 90, 420, 2), span(5, "graph.replay", 100, 104, 4),
    span(6, "fit.step", 590, 900, 2), span(7, "graph.replay", 600, 610, 6),
    span(8, "prefetch.produce", 0, 700, thread=WORKER),
]

# Serving stretch, anchored by the spans' own ranges in a trace with the
# host's operators (a user_annotation, a cpu_op): trace µs = host µs + 501,
# the first range ending as its span does, the second 0.5 µs before. Each
# request serve.predict 0-310 (the second 500 later): serve.check 0-100,
# serve.cast 100-150, graph.copy_in 150-160, graph.replay 160-170,
# serve.fetch 170-300. Device 665-760 and a copy 770-775 a request (100 µs
# busy); runtime calls 500-501 and 1300-1400. Idle 165 + 10 + 390 + 10 +
# 125 = 700 µs; under the check or the cast 2 x 150; unattributed the 200
# µs from 801 to 1001 (serve.predict alone, then no span). An untraced
# request of 1 ms has 900 µs of idle, 300/700 of it under the prep spans.
SERVE_EVENTS = [
    x("cudaDeviceSynchronize", "cuda_runtime", 500, 1),
    x("cudaDeviceSynchronize", "cuda_runtime", 1300, 100),
    x("serve.predict", "user_annotation", 501, 310),
    x("serve.predict", "cpu_op", 1001.5, 309),
    x("gemm", "kernel", 665, 95), x("Memcpy DtoH", "gpu_memcpy", 770, 5),
    x("gemm", "kernel", 1165, 95), x("Memcpy DtoH", "gpu_memcpy", 1270, 5),
]
SERVE_SPANS = [s for r, at in enumerate((0, 500)) for s in (
    span(10 * r + 1, "serve.predict", at, at + 310),
    span(10 * r + 2, "serve.check", at, at + 100, 10 * r + 1),
    span(10 * r + 3, "serve.cast", at + 100, at + 150, 10 * r + 1),
    span(10 * r + 4, "graph.copy_in", at + 150, at + 160, 10 * r + 1),
    span(10 * r + 5, "graph.replay", at + 160, at + 170, 10 * r + 1),
    span(10 * r + 6, "serve.fetch", at + 170, at + 300, 10 * r + 1))]


def ctx(events, units, **mesh):
    t = TraceSummary(events)
    c = types.SimpleNamespace(trace=t, span=t.window(), unit_s=1e-3,
                              batches=[BATCH] * units, layout=layout(),
                              args={}, traffic={}, reference=Stub, peaks=PEAKS)
    c.busy_per_unit_s = lambda: t.busy_us(*c.span) * 1e-6 / units
    return on_mesh(c, **mesh)


@pytest.fixture
def recorded(monkeypatch):
    """Stand in hand-made spans for the program's."""
    def use(spans):
        monkeypatch.setattr(S, "program_spans", lambda: list(spans))
    return use


def test_the_clocks_are_put_together_by_the_least_difference():
    t = TraceSummary(TRAIN_EVENTS)
    assert S.clock_offset_us(TRAIN_SPANS, t) == 1002.0
    assert S.anchor_gap_us(TRAIN_SPANS, t) == 3.0          # of 0 and 3
    # the first launch ends as its span does: the true offset is at least
    # 1002, the end pairs' greatest difference (1002 and 999)
    assert S.offset_spread_us(TRAIN_SPANS, t) == 0.0
    # a replay's mark, where it has one, is its end anchor; marks taken 3 µs
    # before their spans end, so before the first launch ended: the two
    # bounds cross (1002 against 1106 - 101 = 1005), and the offset stays
    marked = [types.SimpleNamespace(**dict(vars(s), mark_ns=s.end_ns - 3000))
              if s.name == "graph.replay" else s for s in TRAIN_SPANS]
    assert S.clock_offset_us(marked, t) == 1002.0
    assert S.offset_spread_us(marked, t) == -3.0
    s = TraceSummary(SERVE_EVENTS)
    assert S.clock_offset_us(SERVE_SPANS, s) == 501.0       # their own ranges
    assert S.anchor_gap_us(SERVE_SPANS, s) == 0.5
    assert S.offset_spread_us(SERVE_SPANS, s) == 0.0
    assert S.clock_offset_us(TRAIN_SPANS, TraceSummary(SERVE_EVENTS[:2])) is None


@pytest.mark.parametrize("extra", ["replay", "launch"])
def test_replays_and_launches_that_differ_in_number_have_no_offset(extra):
    """A replay span of an earlier stretch, or a graph launched outside the
    program's StepGraph: nothing is paired."""
    spans, events = list(TRAIN_SPANS), list(TRAIN_EVENTS)
    if extra == "replay":
        spans.append(span(9, "graph.replay", -9000, -8990))
    else:
        events.append(x("cudaGraphLaunch", "cuda_runtime", 1700, 4))
    t = TraceSummary(events)
    assert S.anchors(spans, t) == S.anchors(spans, t, end=False) == []
    assert S.clock_offset_us(spans, t) is None
    assert S.anchor_gap_us(spans, t) is None
    assert S.offset_spread_us(spans, t) is None


def test_every_replay_encloses_its_launch_once_aligned():
    t = TraceSummary(TRAIN_EVENTS)
    off = S.clock_offset_us(TRAIN_SPANS, t)
    replays = [s for s in TRAIN_SPANS if s.name == "graph.replay"]
    launches = [h for h in t.host if h.name == "cudaGraphLaunch"]
    for s, h in zip(replays, launches):
        assert s.start_ns / 1e3 + off <= h.start and h.end <= s.end_ns / 1e3 + off


def test_phases_and_pieces():
    t = TraceSummary(TRAIN_EVENTS)
    assert S.phase_busy_us(t, *t.window()) == ({
        "gather": 40.0, "forward": 140.0, "backward": 200.0, "optimizer": 80.0,
        "table_update": 120.0}, 2)
    # a step short of a marker (the first gather dropped) is left out whole
    dropped = TraceSummary([e for e in TRAIN_EVENTS
                            if (e["name"], e["ts"]) != ("rf_span_gather", 1110)])
    assert S.phase_busy_us(dropped, *dropped.window()) == ({
        "gather": 20.0, "forward": 70.0, "backward": 100.0, "optimizer": 40.0,
        "table_update": 60.0}, 1)
    tree = [span(1, "a", 0, 10), span(2, "b", 2, 5, 1), span(3, "c", 7, 9, 1),
            span(4, "d", 12, 15), span(5, "e", 3, 4, 2)]
    assert S.self_pieces((s.start_ns, s.end_ns, s) for s in tree) == [
        (0, 2000, "a"), (2000, 3000, "b"), (3000, 4000, "e"), (4000, 5000, "b"),
        (5000, 7000, "a"), (7000, 9000, "c"), (9000, 10000, "a"),
        (12000, 15000, "d")]
    v = S.SpanView(TRAIN_SPANS, t, t.window(), ("fit.stack", "fit.step"))
    assert v.thread == MAIN and v.idle_us() == 506.0
    assert v.units(["fit.stack"], "steps") == v.units(["fit.step"]) == 2
    assert v.units(["prefetch.produce"]) == 0              # another thread
    assert v.idle_under(["fit.next", "fit.pin"]) == 50.0
    assert v.idle_under(["fit.stack"]) == 30.0 + 170.0
    assert v.idle_unattributed(("fit.stack", "fit.step")) == 292.0


GATHER_BYTES = 2 * (4 * 8 + 128 * 7 + 128 * 6)        # test_trace_and_metrics
UPDATE_BYTES = 2 * (5 * 64 * (2 * 2 + 4) + 3 * 8)
TRAIN_CASES = [
    ("gather_span_roofline.train", 100 * GATHER_BYTES * 1e-9 / 40e-6),
    ("table_update_span_roofline", 100 * UPDATE_BYTES * 1e-9 / 120e-6),
    ("dense_span_mfu", 100 * 2 * 3e6 / 340e-6 / 1e12),
    ("optimizer_span_ms.train", 0.040),
    ("input_idle_ms.train", 0.703 * 50 / 506),
    ("idle_unattributed_share.train", 100 * 292 / 506),
]
SERVE_CASES = [
    ("host_prep_idle_ms.serve", 0.9 * 300 / 700),
    ("idle_unattributed_share.serve", 100 * 200 / 700),
]


@pytest.mark.parametrize("name,want", TRAIN_CASES + SERVE_CASES,
                         ids=[c[0] for c in TRAIN_CASES + SERVE_CASES])
def test_reader_counts(recorded, name, want):
    train = (name, want) in TRAIN_CASES
    recorded(TRAIN_SPANS if train else SERVE_SPANS)
    got = reader(name).read(ctx(TRAIN_EVENTS if train else SERVE_EVENTS, 2))
    assert math.isclose(got, want, rel_tol=1e-9), (got, want)


def test_a_span_share_is_at_most_its_kernels_share(recorded):
    recorded(TRAIN_SPANS)
    c = ctx(TRAIN_EVENTS, 2)
    for span_metric, kernel_metric in (
            ("gather_span_roofline.train", "gather_rows_roofline.train"),
            ("table_update_span_roofline", "table_update_roofline")):
        assert reader(span_metric).read(c) <= reader(kernel_metric).read(c)


NAMES = [c[0] for c in TRAIN_CASES + SERVE_CASES]


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_a_recorder_reads_nothing(monkeypatch, name):
    monkeypatch.setattr(S, "PROFILING", "portbench.no_such_module")
    assert S.program_spans() is None
    events = TRAIN_EVENTS if name in dict(TRAIN_CASES) else SERVE_EVENTS
    assert reader(name).read(ctx(events, 2)) is None
    monkeypatch.setattr(S, "PROFILING", "portbench.harness.roofline")
    assert S.program_spans() is None
    assert reader(name).read(ctx(events, 2)) is None


@pytest.mark.parametrize("name", NAMES)
def test_no_recorded_span_reads_nothing(recorded, name):
    recorded([])
    events = TRAIN_EVENTS if name in dict(TRAIN_CASES) else SERVE_EVENTS
    assert reader(name).read(ctx(events, 2)) is None


@pytest.mark.parametrize("name,want", TRAIN_CASES[:4],
                         ids=[c[0] for c in TRAIN_CASES[:4]])
def test_a_step_short_of_a_marker_leaves_the_phase_readers_as_they_were(
        recorded, name, want):
    """The profiler drops the first gather marker: the phase readers read
    the other step alone, which is like the first, so they read as before."""
    recorded(TRAIN_SPANS)
    events = [e for e in TRAIN_EVENTS
              if (e["name"], e["ts"]) != ("rf_span_gather", 1110)]
    got = reader(name).read(ctx(events, 2))
    assert math.isclose(got, want, rel_tol=1e-9), (got, want)


@pytest.mark.parametrize("name", NAMES)
def test_spans_that_count_other_than_the_traced_units_read_nothing(
        recorded, name):
    """Three traced units against spans of two, or one traced step against
    two marked: every reader reads nothing rather than divide by the wrong
    number."""
    recorded(TRAIN_SPANS if name in dict(TRAIN_CASES) else SERVE_SPANS)
    events = TRAIN_EVENTS if name in dict(TRAIN_CASES) else SERVE_EVENTS
    phase = name in dict(TRAIN_CASES[:4])
    assert reader(name).read(ctx(events, 1 if phase else 3)) is None


@pytest.mark.parametrize("name", [n for n in NAMES if "idle" in n])
def test_spans_that_cannot_be_aligned_read_nothing(recorded, name):
    """A trace with one launch more than the program's replays, or without
    the spans' own ranges: the idle readers read nothing."""
    if name in dict(TRAIN_CASES):
        recorded(TRAIN_SPANS)
        events = TRAIN_EVENTS + [x("cudaGraphLaunch", "cuda_runtime", 1700, 4)]
    else:
        recorded(SERVE_SPANS)
        events = [e for e in SERVE_EVENTS if e["name"] != "serve.predict"]
    assert reader(name).read(ctx(events, 2)) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_trace_without_markers_or_device_work_reads_nothing(recorded, name):
    """Spans, but no phase marker and no device event: the phase readers
    find no phase, the idle readers no device work to be idle between."""
    recorded(TRAIN_SPANS if name in dict(TRAIN_CASES) else SERVE_SPANS)
    host_only = [e for e in TRAIN_EVENTS + SERVE_EVENTS
                 if e["cat"] in ("cuda_runtime", "user_annotation")]
    assert reader(name).read(ctx(host_only, 2)) is None


def test_the_program_reports_its_spans():
    """The program's recorder is found, and returns a list."""
    assert isinstance(S.program_spans(), list)


@pytest.mark.cuda
@pytest.mark.parametrize("workload,top", [("dssm_recall-train_zipf", "fit.step"),
                                          ("dssm_recall-serve_top100", "predict"),
                                          ("dcn_criteo-score_2048", "serve.predict")])
def test_on_the_card_spans_count_the_traced_units_and_hold_their_launches(
        workload, top):
    """At small sizes on the card, a traced window's spans: one top-level
    span per traced step or request, and every graph.replay span, once
    aligned, holds its cudaGraphLaunch, the median one within 100 µs of
    it: far under a step or a request, so no replay is paired with
    another's launch. Training runs fit's stacks of 8, so that its steps
    are graphed."""
    import importlib

    import torch

    from portbench.harness.cell import Cell
    from portbench.harness.paths import make_path
    from portbench.tests.small import small_cell
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    importlib.import_module(S.PROFILING)._SPANS.clear()
    cell = small_cell(workload)
    if top == "fit.step":
        cell = Cell(workload, config=cell.config, limits=cell.limits,
                    traffic=dict(cell.traffic, pool_batches=16, stack_steps=8))
    path = make_path(cell, torch.device("cuda", 0), 2**31 + 11)
    path.setup()
    w = path.window(2.0, True)
    spans = S.program_spans()
    assert sum(s.name == top for s in spans) == len(w.traced_batches) > 0
    off = S.clock_offset_us(spans, w.trace)
    replays = sorted((s for s in spans if s.name == "graph.replay"),
                     key=lambda s: s.start_ns)
    launches = sorted((h for h in w.trace.host if "cudaGraphLaunch" in h.name),
                      key=lambda h: h.start)
    assert len(replays) == len(launches) > 0
    for s, h in zip(replays, launches):
        assert s.start_ns / 1e3 + off <= h.start and h.end <= s.end_ns / 1e3 + off
    assert S.anchor_gap_us(spans, w.trace) <= 100.0


def test_phase_readers_of_the_embedding_on_a_mesh(recorded):
    """A row-sharded table is looked up in the forward phase: the gather
    phase's roofline reads nothing, on any number of ranks. The table
    update's reads nothing where a rank updates rows for the others' ids,
    and as on one card where the tables are held whole on every rank."""
    recorded(TRAIN_SPANS)
    gather = reader("gather_span_roofline.train")
    update = reader("table_update_span_roofline")
    assert gather.read(ctx(TRAIN_EVENTS, 2, world=1, row_sharded=(64,))) is None
    assert gather.read(ctx(TRAIN_EVENTS, 2, world=4, row_sharded=(64,))) is None
    assert update.read(ctx(TRAIN_EVENTS, 2, world=4, row_sharded=(64,))) is None
    for name, want in TRAIN_CASES[:2]:
        got = reader(name).read(ctx(TRAIN_EVENTS, 2, world=4))
        assert math.isclose(got, want, rel_tol=1e-9), (name, got, want)
