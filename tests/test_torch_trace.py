"""utils/trace.py, the reader of torch.profiler Chrome traces (the
counterpart of utils/xplane.py; tests/test_xplane.py's cases): a CPU capture
of a short Trainer.fit with its profiler window (a missing directory, the
wrong device class, the span, the ops listed, the window's optimizer
steps), and hand-made traces for exact numbers: two overlapping kernels
and a gap, the launching op's recorded shapes, step annotations, the
newest file of a directory, a gzipped trace."""
import gzip
import json
import os
import time

import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch.utils.trace import (OpTime, format_report,
                                                 input_bytes, parse_trace,
                                                 profile_report, read_trace)


def test_input_bytes_shape_model():
    dims = [[87040, 64], [1505024, 256], [], [2], [[3, 4], [5]]]
    types = ["float", "c10::BFloat16", "Scalar", "long int", "TensorList"]
    assert input_bytes(dims, types) == 87040 * 64 * 4 + 1505024 * 256 * 2 \
        + 2 * 8
    assert input_bytes([], []) == 0


def test_parse_trace_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        parse_trace(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        parse_trace(str(tmp_path / "nowhere"))


@pytest.fixture(scope="module")
def cpu_capture(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("prof"))
    trainer = tp.demo_trainer({"tower_units": [32]}, dropout=0.0)
    trainer.fit(tp.demo_batches(5, seed=30, batch=32), epochs=1,
                profile_dir=d, profile_steps=(1, 4), verbose=False)
    return d


def test_parse_trace_cpu_capture(cpu_capture):
    rep = parse_trace(cpu_capture, device="cpu")
    assert rep.span_ms > 0 and 0 < rep.device_total_ms <= rep.span_ms
    keys = {op.key for op in rep.ops}
    assert {"aten::addmm", "aten::mm"} & keys
    assert "AddmmBackward0" in keys               # the backward's ops too
    assert [op.total_ms for op in rep.ops] == sorted(
        (op.total_ms for op in rep.ops), reverse=True)
    assert all(op.name == op.key and op.count > 0 for op in rep.ops)
    # no record_shapes in fit's window: no byte estimate
    assert all(op.bytes_est == 0 for op in rep.ops)
    assert len(rep.step_spans_ms) == 3          # Optimizer.step, steps 1-3
    text = format_report(rep, steps=3)
    assert "per-step device time" in text and "aten::" in text


def test_parse_trace_wrong_device_class(cpu_capture):
    with pytest.raises(ValueError, match="no populated 'cuda'"):
        parse_trace(cpu_capture)
    with pytest.raises(ValueError, match="device must be"):
        parse_trace(cpu_capture, device="tpu")


def test_profile_report_of_a_profiler_run():
    """A torch.profiler run of the caller's own, with record_shapes: the
    ops carry the bytes of their recorded inputs."""
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        for _ in range(3):
            torch.mm(a, b)
    rep = profile_report(p, device="cpu")
    (mm,) = [op for op in rep.ops if op.key == "aten::mm"]
    assert mm.count == 3 and mm.bytes_est == (64 * 32 + 32 * 16) * 4
    assert mm.gbps > 0


# ---------------------------------------------------- hand-made traces
def _ev(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _trace():
    """Host ops launching two kernels that overlap on two streams (10-30
    and 20-50 us), a gap, a memcpy (100-110) and a kernel (120-125) whose
    runtime call carries the op's id; two profiler steps; the card's copy
    of an annotation, which is not device work."""
    return {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        _ev("cpu_op", "aten::mm", 0, 8, **{
            "External id": 7, "Input Dims": [[64, 32], [32, 16]],
            "Input type": ["float", "float"]}),
        _ev("cpu_op", "recflow::gather_rows", 9, 4, **{
            "External id": 8, "Input Dims": [[1000, 64], [100]],
            "Input type": ["c10::BFloat16", "int"]}),
        _ev("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=55,
            **{"External id": 8}),
        _ev("kernel", "gemm_kernel", 10, 20, pid=0, tid=7,
            **{"External id": 7, "correlation": 54}),
        _ev("kernel", "gather_rows_kernel", 20, 30, pid=0, tid=8,
            correlation=55),
        _ev("gpu_memcpy", "Memcpy HtoD", 100, 10, pid=0, tid=7),
        _ev("kernel", "gemm_kernel", 120, 5, pid=0, tid=7,
            **{"External id": 7}),
        _ev("gpu_user_annotation", "ProfilerStep#1", 0, 500, pid=0, tid=9),
        _ev("user_annotation", "ProfilerStep#2", 60, 70),
        _ev("user_annotation", "ProfilerStep#1", 0, 55),
        _ev("user_annotation", "Optimizer.step#Adam.step", 5, 3),
        {"ph": "s", "cat": "ac2g", "name": "flow", "pid": 1, "tid": 1,
         "ts": 11, "id": 55},
    ]}


def test_hand_made_trace_exact(tmp_path):
    path = tmp_path / "a.pt.trace.json"
    path.write_text(json.dumps(_trace()))
    rep = parse_trace(str(tmp_path))
    # union: [10, 50) + [100, 110) + [120, 125) = 55 us
    assert rep.device_total_ms == pytest.approx(0.055)
    assert rep.span_ms == pytest.approx(0.115)
    assert rep.step_spans_ms == pytest.approx([0.055, 0.070])
    assert rep.plane == "GPU 0" and rep.events == 4
    by = {op.key: op for op in rep.ops}
    assert list(by) == ["gather_rows_kernel", "gemm_kernel", "Memcpy HtoD"]
    assert by["gemm_kernel"] == OpTime("aten::mm", "gemm_kernel",
                                       pytest.approx(0.025), 2,
                                       (64 * 32 + 32 * 16) * 4)
    # linked through its runtime call's correlation
    assert by["gather_rows_kernel"].name == "recflow::gather_rows"
    assert by["gather_rows_kernel"].bytes_est == 1000 * 64 * 2 + 100 * 4
    assert by["Memcpy HtoD"].bytes_est == 0
    host = read_trace(str(path), device="cpu")
    assert {op.key for op in host.ops} == {"aten::mm",
                                           "recflow::gather_rows"}
    assert host.device_total_ms == pytest.approx(0.012)
    text = format_report(rep, steps=2)
    assert "busy 0.06 ms" in text and "gemm_kernel :: aten::mm" in text


def test_optimizer_steps_when_no_profiler_steps(tmp_path):
    t = _trace()
    t["traceEvents"] = [e for e in t["traceEvents"]
                        if not str(e.get("name")).startswith("ProfilerStep")]
    (tmp_path / "b.pt.trace.json").write_text(json.dumps(t))
    assert parse_trace(str(tmp_path)).step_spans_ms == pytest.approx([0.003])


def test_the_newest_trace_wins_and_gzip_reads(tmp_path):
    old = tmp_path / "run" / "old.pt.trace.json"
    old.parent.mkdir()
    t = _trace()
    old.write_text(json.dumps({"traceEvents": t["traceEvents"][:4]}))
    past = time.time() - 100
    os.utime(old, (past, past))
    with pytest.raises(ValueError, match="no populated 'cuda'"):
        read_trace(str(old))
    new = tmp_path / "run" / "new.pt.trace.json.gz"
    with gzip.open(new, "wt") as f:
        json.dump(t, f)
    assert parse_trace(str(tmp_path)).device_total_ms == pytest.approx(0.055)
