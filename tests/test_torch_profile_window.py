"""The fit profiler window and utils/profiling.py on the CPU.

`Trainer.fit(profile_dir=, profile_steps=(a, b))` traces epoch 0's steps a
to b - 1 (the JAX trainer's window: opened at n_steps >= a, closed at
>= b, never reopened, closed at the epoch's end when the epoch is shorter)
and writes one Chrome trace: the trace holds one `Optimizer.step` per step
of the window, and the program's spans inside it by name. A second fit in
the same process traces again. The port's memory_percent equals the JAX
module's exactly under the same patched /proc/meminfo. The span recorder
is held in test_torch_spans.py.
"""
import builtins
import glob
import io
import json
import os

import _torch_parity as tp


def _batches(n):
    return tp.demo_batches(n, seed=60)


def _port():
    return tp.demo_trainer({"tower_units": [64, 32]})


def _traces(d):
    return sorted(glob.glob(os.path.join(str(d), "*.pt.trace.json")))


def _optimizer_steps(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("cat") == "user_annotation" and
               str(e.get("name", "")).startswith("Optimizer.step")
               for e in events)


def test_the_window_traces_its_steps_of_epoch_0_only(tmp_path):
    r = _port().fit(_batches(6), epochs=2, profile_dir=str(tmp_path),
                    profile_steps=(2, 4), verbose=False)
    assert r["state"].step == 12
    (trace,) = _traces(tmp_path)
    assert _optimizer_steps(trace) == 2          # steps 2 and 3


def test_a_short_epoch_closes_and_writes_the_trace(tmp_path):
    _port().fit(_batches(4), epochs=1, profile_dir=str(tmp_path),
                profile_steps=(2, 100), verbose=False)
    (trace,) = _traces(tmp_path)
    assert _optimizer_steps(trace) == 2          # steps 2 and 3


def test_a_second_fit_traces_again(tmp_path):
    trainer = _port()
    r = trainer.fit(_batches(4), epochs=1, profile_dir=str(tmp_path / "a"),
                    profile_steps=(1, 3), verbose=False)
    trainer.fit(_batches(4), epochs=1, state=r["state"], resume_data=False,
                profile_dir=str(tmp_path / "b"), profile_steps=(0, 1),
                verbose=False)
    (a,), (b,) = _traces(tmp_path / "a"), _traces(tmp_path / "b")
    assert _optimizer_steps(a) == 2 and _optimizer_steps(b) == 1


def test_the_window_records_the_programs_spans(tmp_path):
    """Inside the window the program's spans are recorded and are in the
    Chrome trace by name: one fit.step a step of the window."""
    from recommendflow_tpu_torch.utils import profiling
    profiling._SPANS.clear()
    _port().fit(_batches(6), epochs=1, profile_dir=str(tmp_path),
                profile_steps=(2, 5), verbose=False)
    (trace,) = _traces(tmp_path)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    named = [e for e in events if e.get("cat") in ("user_annotation", "cpu_op")
             and e.get("name") == "fit.step"]
    assert len(named) == 3                       # steps 2, 3 and 4
    assert sum(s.name == "fit.step" for s in profiling.spans()) == 3
    profiling._SPANS.clear()


def test_trace_context_writes_one_trace(tmp_path):
    import torch
    from recommendflow_tpu_torch.utils.profiling import trace
    with trace(str(tmp_path)):
        torch.ones(8).sum()
    assert len(_traces(tmp_path)) == 1


def test_memory_percent_matches_jax(monkeypatch):
    from recommendflow_tpu.utils import profiling as jprof
    from recommendflow_tpu_torch.utils import profiling as tprof
    meminfo = ("MemTotal:       16000000 kB\nMemFree:         2000000 kB\n"
               "MemAvailable:    6000000 kB\n")
    real = builtins.open

    def fake_open(path, *a, **kw):
        if path == "/proc/meminfo":
            return io.StringIO(meminfo)
        return real(path, *a, **kw)
    monkeypatch.setattr(builtins, "open", fake_open)
    assert tprof.memory_percent() == jprof.memory_percent() == 62.5
    meminfo = "MemTotal: 1000 kB\nMemFree: 250 kB\n"
    assert tprof.memory_percent() == jprof.memory_percent() == 75.0
