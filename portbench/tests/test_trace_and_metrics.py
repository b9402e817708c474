"""The frozen interval arithmetic and every per-layer reader's counts,
against hand counts on hand-made traces and batches."""
import math
import types

import numpy as np
import pytest

from portbench.harness.cell import Cell
from portbench.harness.run_cell import Context
from portbench.harness.trace import TraceSummary, union_us
from portbench.reference.layout import Layout

PEAKS = {"bytes_per_s": 1e9, "f32_flops": 1e12, "bf16_flops": 1e13}


def test_union_counts_overlaps_once_and_gaps_not_at_all():
    assert union_us([]) == 0.0
    assert union_us([(0, 10), (5, 15), (20, 30)]) == 25.0
    assert union_us([(20, 30), (0, 10), (10, 12)]) == 22.0
    assert union_us([(0, 100), (10, 20)]) == 100.0


def x(name, cat, ts, dur, **kw):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **kw}


EVENTS = [
    x("cudaStreamSynchronize", "cuda_runtime", 1000, 5, tid=1),
    x("cudaMemcpyAsync", "cuda_runtime", 1520, 60, tid=1),
    x("cudaLaunchKernel", "cuda_runtime", 2050, 100, tid=1),
    x("cudaStreamSynchronize", "cuda_runtime", 2950, 50, tid=1),
    x("void gather_rows_kernel<int>(...)", "kernel", 1100, 100),
    x("volta_sgemm_128x64", "kernel", 1200, 300),
    x("void sparse_adagrad_kernel<bf16>(...)", "kernel", 1300, 50),
    x("void grouped_score_max_kernel<4>(...)", "kernel", 1600, 100),
    x("Memcpy HtoD", "gpu_memcpy", 2500, 100),
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}},
]


def test_summary_reads_busy_kernels_ops_and_gaps():
    t = TraceSummary(EVENTS)
    assert t.window() == (1000.0, 3000.0)      # the extent of its events
    assert TraceSummary([]).window() is None
    assert t.busy_us(1000, 3000) == 600.0          # 1100-1500, 1600-1700, 2500-2600
    assert t.busy_us(1000, 1600) == 400.0
    assert t.busy_us(1150, 1250) == 100.0
    assert t.kernel_us(("gather_rows_kernel",), 1000, 3000) == 100.0
    assert t.kernel_us(("gather_rows_kernel",), 1150, 3000) == 50.0
    assert t.kernel_us(("nothing",), 1000, 3000) == 0.0
    top = t.top_ops(1000, 3000)
    assert top[0] == ["volta_sgemm_128x64", 300e-6]
    assert len(top) == 5
    gaps = t.idle_gaps(1000, 3000)
    # 1700-2500 (800), 2600-3000 (400), 1000-1100 (100), 1500-1600 (100)
    assert [round(g[1] * 1e6) for g in gaps] == [800, 400, 100, 100]
    # each named by the innermost host event under way at its middle
    assert [g[0] for g in gaps[:3]] == ["cudaLaunchKernel", "host outside CUDA calls",
                                        "host outside CUDA calls"]
    assert t.idle_gaps(1500, 1600) == [["cudaMemcpyAsync", 100e-6]]


def layout():
    return Layout({
        "features": [
            {"name": "f1", "kind": "sparse", "tower": "user", "max_len": 2,
             "hashes": 1, "rows": 10, "dim": 64, "pooling": "sum"},
            {"name": "f2", "kind": "sparse", "tower": "ad", "max_len": 1,
             "hashes": 2, "rows": 5, "dim": 64, "pooling": "sum"},
            {"name": "d1", "kind": "dense", "tower": "ad", "max_len": 1}],
        "labels": ["label"], "precision": {"tables": "bfloat16"},
        "optimizer": {"tables": {"row_bytes": 512}}})


BATCH = {"f1": np.array([[[1, 2]], [[0, 1]]], np.int32),
         "f2": np.array([[[3], [4]], [[0], [2]]], np.int32),
         "d1": np.zeros((2, 1), np.float32), "label": np.zeros(2, np.float32)}


class Stub:
    @staticmethod
    def forward_flops(layout, args, rows, training):
        return 1e6


def on_mesh(c, world=1, row_sharded=()):
    """A stand-in context's mesh: `world` ranks, `row_sharded` table widths."""
    c.world, c.row_sharded = world, tuple(row_sharded)
    c.lookups_for_other_ranks = types.MethodType(Context.lookups_for_other_ranks, c)
    return c


def ctx(traffic, events=EVENTS, unit_s=1000e-6, **mesh):
    t = TraceSummary(events)
    units = traffic.pop("units", 1)
    return on_mesh(types.SimpleNamespace(
        trace=t, span=t.window(), unit_s=unit_s, batches=[BATCH] * units,
        busy_per_unit_s=lambda: t.busy_us(*t.window()) * 1e-6 / units,
        layout=layout(), args={}, traffic=traffic, reference=Stub, peaks=PEAKS),
        **mesh)


def reader(name):
    return Cell("dssm_recall-train_zipf").reader(name)


def test_layout_ids():
    lay = layout()
    g = lay.groups[64]
    assert g.offsets == {("f1", 0): 0, ("f2", 0): 10, ("f2", 1): 15}
    assert (g.rows, g.pack, g.stored_rows) == (20, 4, 256)
    gids, valid = lay.group_ids(BATCH)[64]
    assert gids.tolist() == [1, 2, 0, 1, 13, 19, 10, 17]
    assert valid.tolist() == [True, True, False, True, True, True, False, True]


# hand counts (module docstring of each reader): 8 ids, 6 not pad; logical
# rows {0,1,2,10,13,17,19} of 64 x 2 = 128 bytes, whatever the 4-to-a-row
# packing; the table update touches 5 logical rows {1,2,13,17,19}
# (128 bytes read and written and a 64 x 4-byte gradient read each) in 3
# stored rows {0,3,4} (an accumulator of 4 bytes read and written each).
# Busy 600 us in the stretch; a unit 1000 us untraced.
CASES = [
    ("gather_rows_roofline.train", {}, 100 * (4 * 8 + 128 * 7 + 128 * 6) * 1e-9 / 100e-6),
    ("gather_rows_roofline.serve", {}, 100 * (4 * 8 + 128 * 7 + 128 * 6) * 1e-9 / 100e-6),
    ("table_update_roofline", {}, 100 * (5 * 64 * (2 * 2 + 4) + 3 * 8) * 1e-9 / 50e-6),
    ("idle_share.train", {}, 100 * (1 - 600 / 1000)),
    ("idle_share.serve", {"units": 2}, 100 * (1 - 300 / 1000)),
    ("exposed_host_ms.serve", {"units": 2}, 0.7),
    ("train_mfu", {}, 100 * 3e6 / 1000e-6 / 1e12),
    ("serve_mfu", {"rows": 2, "units": 2}, 100 * 1e6 / 1000e-6 / 1e12),
    ("score_max_roofline", {"rows": 2, "units": 2,
                            "catalogue": {"items": 32, "dim": 4}},
     100 * 2 * (4 * 32 * 4 + 4 * 2 * 4 + 4 * 2 * 32 / 16) * 1e-9 / 100e-6),
]


@pytest.mark.parametrize("name,traffic,want", CASES, ids=[c[0] for c in CASES])
def test_reader_counts(name, traffic, want):
    got = reader(name).read(ctx(dict(traffic)))
    assert math.isclose(got, want, rel_tol=1e-9), (got, want)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_finds_nothing_returns_nothing(name):
    empty = TraceSummary([x("cudaStreamSynchronize", "cuda_runtime", 0, 100)])
    c = on_mesh(types.SimpleNamespace(trace=empty, span=(0.0, 100.0), unit_s=None,
                                      busy_per_unit_s=lambda: 0.0,
                                      batches=[], layout=layout(), args={},
                                      traffic={"rows": 2}, reference=Stub,
                                      peaks=PEAKS))
    assert reader(name).read(c) is None


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_of_a_stretch_without_device_work_returns_nothing(name):
    host_only = [e for e in EVENTS if e.get("cat") == "cuda_runtime"]
    traffic = dict(CASES[[c[0] for c in CASES].index(name)][1])
    got = reader(name).read(ctx(traffic, events=host_only))
    if name in ("train_mfu", "serve_mfu"):
        # the whole step's share reads the host clock and the FLOPs alone
        assert got is not None and got > 0
    else:
        assert got is None


# On a mesh: NCCL's all-reduce 1650-1900 over the sgemm's 1600-1700, so the
# exchange alone runs 1700-1900. The work's busy time stays 600 of the
# window's 2000 us; 1400 without work, 200 of it the exchange's. An
# untraced step of 1000 us has 400 us without work: 400 * 200 / 1400.
NCCL = x("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
         "kernel", 1650, 250)


def test_the_exchange_between_ranks_is_not_the_cards_work():
    t = TraceSummary(EVENTS + [NCCL])
    assert t.exchange and not TraceSummary(EVENTS).exchange
    assert t.busy_us(1000, 3000) == 600.0
    assert t.occupied_us(1000, 3000) == 800.0
    assert t.exchange_only_us(1000, 3000) == 200.0
    assert t.exchange_only_us(1000, 1800) == 100.0
    # the gaps are those in which nothing ran, the exchange neither
    assert [round(g[1] * 1e6) for g in t.idle_gaps(1000, 3000)][:2] == [600, 400]
    assert [NCCL["name"], 250e-6] in t.top_ops(1000, 3000)    # by its own name
    # on one card the three agree
    one = TraceSummary(EVENTS)
    assert one.occupied_us(1000, 3000) == one.busy_us(1000, 3000) == 600.0
    assert one.exchange_only_us(1000, 3000) == 0.0


def test_exposed_exchange_and_idle_share_on_a_mesh():
    exposed = reader("nccl_exposed_ms.train")
    c = ctx({}, events=EVENTS + [NCCL], world=4)
    assert math.isclose(exposed.read(c), 1e3 * 400e-6 * 200 / 1400, rel_tol=1e-12)
    # the exchange's own time counts as idle: the work's share is as before
    assert math.isclose(reader("idle_share.train").read(c), 40.0, rel_tol=1e-12)
    # one card: no exchange to read
    assert exposed.read(ctx({})) is None
    # the exchange wholly under the work: none of it exposed
    hidden = dict(NCCL, ts=1250, dur=200)
    assert exposed.read(ctx({}, events=EVENTS + [hidden], world=4)) == 0.0


@pytest.mark.parametrize("name", ["gather_rows_roofline.train", "table_update_roofline"])
def test_rows_fed_to_a_rank_that_looks_up_for_all_count_nothing(name):
    """Row-sharded tables on several ranks: each rank's kernels serve the
    global batch's ids in its block, which its fed rows do not count. One
    rank, or tables held whole on every rank, read as on one card."""
    want = reader(name).read(ctx({}))
    assert reader(name).read(ctx({}, world=2, row_sharded=(64,))) is None
    assert reader(name).read(ctx({}, world=1, row_sharded=(64,))) == want
    assert reader(name).read(ctx({}, world=4)) == want
