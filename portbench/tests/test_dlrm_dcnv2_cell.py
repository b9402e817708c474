"""The dlrm_dcnv2-train cell: its configuration at MLPerf's widths, its
reference's FLOPs, the cell at a small size on a mesh of two CPU ranks
(`small.mesh_cell`: the tables cut to a few hundred rows but for the two
that the ranks shard, the widths as stated), correct, and not correct
under the half-batch and no-exchange faults; and the cell's three new
readers on hand-made traces and spans, None without their markers or
spans.

At its small size the cell's readings are judged by the accepted training
cells' limits (dcn_criteo-train_zipf's). Its own limits are set on four
cards at full size. There the table's first gradient agrees within 1e-7:
the mesh path's table gradient is the block's dense gradient in the
table's dtype, each entry rounded once to bf16, and its norm averages
those roundings over the millions of rows a global batch touches; over
the few thousand of a small batch of 32 they average to 2e-4."""
import json
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest

from portbench.harness import spans as S
from portbench.harness.cell import BENCH_DIR, ROOT, Cell, read_json
from portbench.harness.run_cell import judge, passed
from portbench.harness.trace import TraceSummary
from portbench.reference import dlrm_dcnv2 as ref
from portbench.reference.layout import Layout

WORKLOAD = "dlrm_dcnv2-train"
SEED = 2**31 + 5151
RUN_LIMIT_S = 200


def cell():
    return Cell(WORKLOAD)


def test_the_configuration_is_at_mlperfs_widths():
    c = cell()
    cfg, args = c.config, c.config["model_args"]
    src = cfg["source_settings"]
    assert cfg["reduced"] == [] and cfg["shard_tables"] is True
    assert cfg["batch_size"] == src["batch_size"] == 65536 and c.chips == 4
    sparse = [f for f in cfg["features"] if f["kind"] == "sparse"]
    dense = [f for f in cfg["features"] if f["kind"] == "dense"]
    assert len(sparse) == 26 and len(dense) == 13
    assert [f["rows"] - 1 for f in sparse] == src["num_embeddings_per_feature"]
    assert [f["max_len"] for f in sparse] == src["multi_hot_sizes"]
    assert sum(f["max_len"] for f in sparse) == 214
    assert sum(f["rows"] for f in sparse) == 204_184_614
    assert {f["dim"] for f in sparse} == {src["embedding_dim"]} == {128}
    assert args["bottom_units"] == src["dense_arch_layer_sizes"] == [512, 256, 128]
    assert args["top_units"] + [1] == src["over_arch_layer_sizes"]
    assert args["cross_layers"] == 3 and args["low_rank"] == 512
    net = cfg["port_conf"]["Networks"]
    assert {k: net[k] for k in ("bottom_units", "cross_layers", "low_rank",
                                "top_units")} == {k: args[k] for k in (
        "bottom_units", "cross_layers", "low_rank", "top_units")}
    assert cfg["port_conf"]["Variables"]["max_len_map"] == {
        f["name"]: f["max_len"] for f in sparse}


def test_the_reference_counts_mlperfs_flops():
    c = cell()
    layout, args = Layout(c.config), c.config["model_args"]
    # a row: 21.26 MFLOP in the cross, 10.49 in the top MLP and head, 0.34
    # in the bottom MLP
    assert ref.interaction_flops(layout, args, 1) == 3 * 3456 * (4 * 512 + 3)
    top = 2 * (3456 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256)
    bottom = 2 * (13 * 512 + 512 * 256 + 256 * 128)
    assert ref.forward_flops(layout, args, 2, True) == \
        2 * (ref.interaction_flops(layout, args, 1) + top + bottom)
    names = [n for n, _, _ in ref.param_specs(layout, args)]
    assert all(c.config_module.port_name(n) for n in names)
    assert c.config_module.port_name("cross2.V") == "cross.V_2.weight"
    assert c.config_module.port_name("top3.bias") == "top.Dense_3.bias"


SMALL_LIMITS = read_json(os.path.join(BENCH_DIR, "limits",
                                      "dcn_criteo-train_zipf.json"))


def small_correct(err):
    """Whether rank 0's readings (its `readings` line on stderr) pass the
    small size's limits."""
    (line,) = [x for x in err.splitlines() if x.startswith("readings ")]
    readings = {k: float(v) for k, v in
                (kv.split("=") for kv in line.split()[1:])}
    assert set(readings) == set(SMALL_LIMITS["numbers"])
    return passed(judge(readings, SMALL_LIMITS))


def launched(*args):
    """(exit code, the result or None, stderr) of `rank_cell` on this cell."""
    p = subprocess.Popen([sys.executable, "-m", "portbench.tests.rank_cell",
                          "--workload", WORKLOAD, *args], cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=RUN_LIMIT_S)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    lines = [x for x in out.strip().splitlines() if x.startswith("{")]
    return p.returncode, json.loads(lines[-1]) if lines else None, err


def test_the_cell_on_two_ranks_is_correct():
    rc, result, err = launched("--chips", "2", "--seed", str(SEED),
                               "--seconds", "1")
    assert rc == 0, err[-3000:]
    assert small_correct(err), result["checks"]
    assert result["device"]["count"] == 2 and result["attempted"] > 0
    for k in range(2):
        assert f"rank {k}: row-sharded over 2 rank(s): dim128" in err


@pytest.mark.parametrize("fault", ["half_batch", "no_exchange"])
def test_a_planted_fault_is_not_correct(fault):
    rc, result, err = launched("--chips", "2", "--seed", str(SEED + 1),
                               "--seconds", "0.5", "--fault", fault)
    assert rc == 0, err[-3000:]
    assert not small_correct(err)
    assert result["correct"] is False


# ---------------------------------------------------------------- readers

def x(name, ts, dur, cat="kernel"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def step(at):
    """One step's cross: markers and 100 µs of forward, 300 of backward
    work between them, and work outside them."""
    return [x("ampere_sgemm_fwd_other", at, 50),
            x("rf_region_cross_forward", at + 50, 1),
            x("ampere_sgemm_fwd", at + 51, 100),
            x("rf_region_cross_forward_end", at + 151, 1),
            x("ampere_sgemm_top", at + 152, 200),
            x("rf_region_cross_backward", at + 400, 1),
            x("ampere_sgemm_bwd", at + 401, 300),
            x("rf_region_cross_backward_end", at + 701, 1),
            x("ncclDevKernel_AllReduce_Sum_f32", at + 702, 400),
            x("rf_span_end", at + 1200, 1)]


def ctx(events, units, rows=64):
    t = TraceSummary(events)
    c = types.SimpleNamespace(trace=t, span=t.window(), unit_s=1e-3,
                              batches=[{"c01": np.zeros(rows)}] * units,
                              layout=Layout(cell().config),
                              args=cell().config["model_args"], reference=ref,
                              peaks={"f32_flops": 67e12})
    return c


def reader(name):
    return cell().reader(name)


def test_interaction_span_mfu_reads_the_markers():
    events = step(0) + step(2000)
    # busy from each start marker to its end marker: 101 forward and 301
    # backward µs a step (the start markers' own µs included)
    flops = 3 * ref.interaction_flops(Layout(cell().config),
                                      cell().config["model_args"], 64)
    got = reader("interaction_span_mfu").read(ctx(events, 2))
    assert got == pytest.approx(100 * flops / 402e-6 / 67e12)
    # the markers count other than the traced steps, or there are none
    assert reader("interaction_span_mfu").read(ctx(events, 3)) is None
    plain = [e for e in events if "rf_region_" not in e["name"]]
    assert reader("interaction_span_mfu").read(ctx(plain, 2)) is None


def span(name, **counts):
    return types.SimpleNamespace(name=name, start_ns=0, end_ns=1, id=1,
                                 parent=None, thread=1, counts=counts,
                                 mark_ns=None)


def test_lookup_exchange_reads_the_spans(monkeypatch):
    read = reader("lookup_exchange_gb.train").read
    c = ctx(step(0) + step(2000), 2)
    fwd, bwd = 7.24e9, 7.18e9
    recorded = [span("fit.step"), span("shard.lookup", ids=14, exchange_bytes=fwd),
                span("shard.lookup_grad", exchange_bytes=bwd)] * 2
    monkeypatch.setattr(S, "program_spans", lambda: list(recorded))
    assert read(c) == pytest.approx((fwd + bwd) / 1e9)
    monkeypatch.setattr(S, "program_spans", lambda: recorded[:4])
    assert read(c) is None                  # a lookup without its backward
    monkeypatch.setattr(S, "program_spans", lambda: [span("fit.step")])
    assert read(c) is None
    monkeypatch.setattr(S, "program_spans", lambda: None)
    assert read(c) is None


def phased_step(at):
    """One eager mesh step's six phase markers, with 70 µs of the block's
    update and 400 of NCCL in its table-update phase, 500 of work before."""
    return [x("rf_span_gather", at, 1),
            x("ampere_sgemm_fwd", at + 10, 200),
            x("rf_span_forward", at + 300, 1),
            x("rf_span_backward", at + 400, 1),
            x("ampere_sgemm_bwd", at + 410, 300),
            x("rf_span_optimizer", at + 800, 1),
            x("rf_span_table_update", at + 900, 1),
            x("row_wise_adagrad", at + 910, 70),
            x("ncclDevKernel_AllReduce_Sum_f32", at + 990, 400),
            x("rf_span_end", at + 1500, 1)]


def test_table_update_span_ms_reads_the_phase(monkeypatch):
    read = reader("table_update_span_ms.train").read
    events = phased_step(0) + phased_step(2000)
    monkeypatch.setattr(S, "program_spans", lambda: [span("fit.step")])
    # the marker's own µs and the update's, NCCL's left out: 71 µs a step
    assert read(ctx(events, 2)) == pytest.approx(0.071)
    # markers counting more steps than were traced, or no whole step
    assert read(ctx(events, 1)) is None
    partial = [e for e in events if e["name"] != "rf_span_end"]
    assert read(ctx(partial, 2)) is None
    monkeypatch.setattr(S, "program_spans", lambda: None)
    assert read(ctx(events, 2)) is None
