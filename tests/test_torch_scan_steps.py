"""Multi-step dispatch on the CPU: `Trainer.train_steps` and
`fit(scan_steps=)` against single steps and against the JAX trainer's
`train_steps` and `fit(scan_steps=)`, the LR the host writes for a step, the
checkpoints of the capturable Adam and the running sums of fit.

On the CPU a stack's steps run eagerly (on a card they replay the step's
CUDA graph: tests/test_torch_cuda.py), so every comparison with single steps
is bitwise: the same operations on the same inputs in the same order.

  * train_steps equals K train_steps in every update mode, under a chosen
    optimizer (lamb with clip_norm, the partitioned adamw), a warmup
    schedule, logQ and the bf16 MLP, at dropout 0.3 (Dssm on demo_recall,
    towers 64-32, batches of 64): the state bitwise, the metrics the mean of
    the single steps' bitwise;
  * train_steps against the JAX Trainer.train_steps from the same carried
    state at dropout 0 (f32 tables): the mean loss rtol 1e-5 and every float
    leaf atol 1e-5 [measured 1.7e-7 and 3.6e-7], test_torch_train.py's
    tolerances for three steps (the same f32 arithmetic summed in another
    order);
  * fit(scan_steps=4) equals fit(scan_steps=1) (6 batches: a stack of 4 and
    two single steps, 2 epochs): the state bitwise and every epoch's logs
    within rtol 1e-6 (a stack's mean weighted by its steps against the sum
    of its steps, in f32); against the JAX fit(scan_steps=4) from the same
    carried state: losses rtol 1e-5, every float leaf atol 1e-5 [measured
    worst 4.8e-7 after 12 steps];
  * a SIGTERM inside a stack stops after the step in flight; the resumed run
    equals the uninterrupted one bitwise;
  * the profiler window and log_every across stacks (>=, as the JAX fit).
"""
import logging
import os
import signal

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

NETS = {"tower_units": [64, 32]}
MODES = {"split-dense": dict(table_update="split", split_strategy="dense"),
         "split-sparse_set": dict(table_update="split",
                                  split_strategy="sparse_set"),
         "split-sparse": dict(table_update="split", split_strategy="sparse"),
         "dense": dict(table_update="dense"),
         "sparse": dict(table_update="sparse")}


def _options():
    from recommendflow_tpu_torch.train.trainer import (
        make_optimizer, make_partitioned_optimizer)
    return {
        **{k: (NETS, v) for k, v in MODES.items()},
        "lamb": (NETS, dict(optimizer=make_optimizer(1e-3, "lamb",
                                                     clip_norm=1.0))),
        "partitioned": (NETS, dict(optimizer=make_partitioned_optimizer(
            1e-3, dense_optimizer="adamw", weight_decay=1e-4,
            clip_norm=1.0))),
        "schedule": (NETS, dict(lr_schedule={"type": "cosine",
                                             "warmup_steps": 2,
                                             "decay_steps": 6})),
        "logq": (dict(NETS, logq_feature="item_id", logq_buckets=1024), {}),
        "bf16_mlp": (dict(NETS, compute_dtype="bfloat16"), {})}


def _snapshot(state):
    from recommendflow_tpu_torch.train.checkpoint import state_to_host
    return state_to_host(state)


def _assert_bitwise(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), f"{path}: max diff " \
            f"{(a.double() - b.double()).abs().max().item()}"
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.mark.parametrize("case", list(_options()))
def test_train_steps_equal_single_steps(case):
    nets, kw = _options()[case]
    batches = tp.demo_batches(5, seed=60).batches
    ta = tp.demo_trainer(nets, **kw)
    sa = ta.init_state(batches[0])
    singles = []
    for b in batches[1:]:
        sa, m = ta.train_step(sa, b)
        singles.append(m)
    tb = tp.demo_trainer(nets, **kw)
    sb = tb.init_state(batches[0])
    sb, mb = tb.train_steps(sb, batches[1:])
    assert sa.step == sb.step == 4
    _assert_bitwise(_snapshot(sa), _snapshot(sb))
    assert sorted(mb) == sorted(singles[0])
    for k, v in mb.items():
        assert torch.equal(v, torch.stack([m[k] for m in singles]).mean(0)), k


def test_train_steps_check_the_ids_first():
    batches = tp.demo_batches(2, seed=61).batches
    t = tp.demo_trainer(NETS)
    state = t.init_state(batches[0])
    bad = dict(batches[1])
    key = next(k for k in bad if bad[k].dtype == np.int32 and bad[k].ndim > 1)
    bad[key] = bad[key].copy()
    bad[key].flat[0] = 1 << 30
    with pytest.raises(IndexError):
        t.train_steps(state, [batches[0], bad])
    assert state.step == 0


# ----------------------------------------------------- against the JAX trainer
def _world(n):
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    jc, tc = tp.conf_pair(networks=dict(NETS, table_dtype="float32"))
    batches = [synthetic_batch(compile_schema(jc.features), 64, seed=40 + i)
               for i in range(n)]
    return jc, tc, batches


def _carried(mode, strategy, n):
    """A JAX trainer after one step and a port trainer holding that state."""
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer
    jc, tc, batches = _world(n)
    jm, _ = jbuild(jc.networks["class"], {"conf": jc, "dropout": 0.0})
    jt = JTrainer(jm, learning_rate=1e-3, table_update=mode, seed=0)
    js = jt.init_state(jt._put(batches[0]))
    if mode == "split":
        jt._split_dims = {d: strategy for d in jt._split_dims}
    js, _ = jt.train_step(js, batches[0])
    tm, _ = build_network(tc.networks["class"],
                          {"conf": tc, "dropout": 0.0, "device": "cpu"})
    tt = Trainer(tm, learning_rate=1e-3, table_update=mode,
                 split_strategy=strategy, device="cpu")
    ts = tt.init_state(batches[0])
    interop.load_train_state(ts, tp.jax_state_tree(js))
    return jt, js, tt, ts, batches


def _hold_state(js, ts):
    jflat = tp.flat_tree(tp.jax_state_tree(js))
    tflat = tp.flat_tree(interop.train_state_tree(ts, ml_dtypes.bfloat16))
    assert sorted(jflat) == sorted(tflat)
    for k, a in jflat.items():
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(tflat[k], a, rtol=0, atol=1e-5,
                                       err_msg=k)
        else:
            assert a == tflat[k], k


@pytest.mark.parametrize("mode,strategy", [("split", "dense"),
                                           ("split", "sparse_set"),
                                           ("dense", "dense")],
                         ids=["split-dense", "split-sparse_set", "dense"])
def test_train_steps_match_jax(mode, strategy):
    jt, js, tt, ts, batches = _carried(mode, strategy, 4)
    js, jm = jt.train_steps(js, batches[1:])
    ts, tm = tt.train_steps(ts, batches[1:])
    assert int(js.step) == ts.step == 4
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _hold_state(js, ts)


def test_fit_scan_steps_matches_jax():
    jt, js, tt, ts, batches = _carried("split", "sparse_set", 6)
    ds = tp.Batches(batches)
    jr = jt.fit(ds, epochs=2, state=js, resume_data=False, scan_steps=4,
                log_every=10 ** 9, verbose=False)
    tr = tt.fit(ds, epochs=2, state=ts, resume_data=False, scan_steps=4,
                log_every=10 ** 9, verbose=False)
    # the carried state is at step 1: both add 12 steps
    assert int(jr["state"].step) == tr["state"].step == 13
    for je, te in zip(jr["history"], tr["history"]):
        np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-5)
    _hold_state(jr["state"], tr["state"])


# -------------------------------------------------------------------- fit
def test_fit_scan_steps_equals_single_steps():
    ds = tp.demo_batches(6, seed=70)
    runs = {}
    for k in (1, 4):
        t = tp.demo_trainer(NETS)
        runs[k] = t.fit(ds, epochs=2, scan_steps=k, verbose=False)
    a, b = runs[1], runs[4]
    assert a["state"].step == b["state"].step == 12
    _assert_bitwise(_snapshot(a["state"]), _snapshot(b["state"]))
    for ea, eb in zip(a["history"], b["history"]):
        assert sorted(ea) == sorted(eb)
        for k in ea:
            if k != "examples_per_sec":
                assert eb[k] == pytest.approx(ea[k], rel=1e-6), k


def test_scan_steps_resolution():
    from recommendflow_tpu_torch.train.trainer import resolve_scan_steps
    assert resolve_scan_steps(None, "cpu") == 1
    assert resolve_scan_steps(None, torch.device("cuda")) == 8
    assert resolve_scan_steps(None, "cuda:0") == 8
    assert resolve_scan_steps(4, "cpu") == 4
    assert resolve_scan_steps(0, "cuda") == 1


def test_chunk_stack_passes_odd_shapes_and_the_tail_as_singles():
    from recommendflow_tpu_torch.train.trainer import _chunk_stack, _Stack

    def batch(rows, fill):
        return {"x": np.full((rows, 3), fill, np.float32),
                "y": np.zeros(rows, np.int32)}
    items = list(_chunk_stack([batch(4, i) for i in range(3)] + [batch(2, 9)]
                              + [batch(4, i) for i in range(5)], 2))
    kinds = [("stack", it.stacked["x"].shape) if isinstance(it, _Stack)
             else ("single", it["x"].shape) for it in items]
    assert kinds == [("stack", (2, 4, 3)), ("single", (4, 3)),
                     ("single", (2, 3)), ("stack", (2, 4, 3)),
                     ("stack", (2, 4, 3)), ("single", (4, 3))]
    assert items[0].rows == 4
    np.testing.assert_array_equal(items[3].stacked["x"][:, 0, 0], [0, 1])


def test_preemption_inside_a_stack_resumes_bitwise(tmp_path):
    """SIGTERM during step 2 of the first stack of 4: fit finishes that step
    and stops at step 3, which is no stack boundary; the checkpoint holds
    whole steps, and a fresh model restored from it and run to the end (its
    stacks now start at other steps) equals the uninterrupted run at both
    scan_steps bit for bit."""
    from recommendflow_tpu_torch.train.checkpoint import restore_checkpoint
    from recommendflow_tpu_torch.train.trainer import \
        install_preemption_handler
    ds = tp.demo_batches(6, seed=75)
    whole = {k: _snapshot(tp.demo_trainer(NETS).fit(
        ds, epochs=2, scan_steps=k, verbose=False)["state"]) for k in (1, 4)}
    _assert_bitwise(whole[1], whole[4])
    t = tp.demo_trainer(NETS)
    real = t._host_step

    def host_step(state):
        if state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        real(state)
    t._host_step = host_step
    saved = install_preemption_handler(t)
    try:
        r = t.fit(ds, epochs=2, scan_steps=4, preempt_dir=str(tmp_path),
                  verbose=False)
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    assert r["preempted"] and r["state"].step == 3
    assert os.listdir(tmp_path) == ["3.pt"]
    t2 = tp.demo_trainer(NETS)
    s2 = restore_checkpoint(str(tmp_path), t2.init_state(ds.batches[0]))
    b = t2.fit(ds, epochs=2, state=s2, scan_steps=4, verbose=False)["state"]
    assert b.step == 12
    _assert_bitwise(whole[4], _snapshot(b))


def test_profile_window_and_log_every_across_stacks(tmp_path, monkeypatch):
    """10 batches at scan_steps=4: stacks at steps 0-3 and 4-7, singles 8 and
    9. profile_steps (3, 6) starts the trace before the first item at or past
    step 3 (the stack 4-7) and stops it before the first at or past 6 (step
    8): steps 4-7 traced. log_every 3 logs where an item crosses a multiple
    of 3: after steps 4, 8 and 9."""
    from recommendflow_tpu_torch.train import trainer as trainer_mod
    events = []
    monkeypatch.setattr(trainer_mod, "start_trace",
                        lambda d: events.append("start") or "trace")
    monkeypatch.setattr(trainer_mod, "stop_trace",
                        lambda tr: events.append("stop"))
    t = tp.demo_trainer(NETS)
    real = t._host_step

    def host_step(state):
        events.append(state.step)
        real(state)
    t._host_step = host_step
    logged = []
    handler = logging.Handler()
    handler.emit = lambda rec: logged.append(rec.getMessage())
    trainer_mod.log.addHandler(handler)
    try:
        t.fit(tp.demo_batches(10, seed=77), epochs=1, scan_steps=4,
              log_every=3, profile_dir=str(tmp_path),
              profile_steps=(3, 6), verbose=False)
    finally:
        trainer_mod.log.removeHandler(handler)
    start, stop = events.index("start"), events.index("stop")
    assert events[start + 1:stop] == [4, 5, 6, 7]
    steps = [int(m.split(" step ")[1].split(":")[0]) for m in logged
             if m.startswith("epoch 0 step ")]
    assert steps == [4, 8, 9]


def test_running_sums_do_not_keep_a_steps_metric_tensor(monkeypatch):
    """fit's epoch sums must copy the first step's metric, not keep it: a
    replayed graph overwrites its metric buffers at the next step. Steps
    that return one buffer rewritten in place (1, 2, ..., 6) must average
    3.5."""
    t = tp.demo_trainer(NETS)
    buf = torch.zeros(())

    def step(state, batch):
        state.step += 1
        buf.fill_(float(state.step))
        return state, {"loss": buf}
    monkeypatch.setattr(t, "_step", step)
    r = t.fit(tp.demo_batches(6, seed=78), epochs=1, scan_steps=1,
              verbose=False)
    assert r["history"][0]["loss"] == 3.5


# ------------------------------------------------ the learning rate a step reads
def test_schedule_lrs_per_step_are_written_before_each_step():
    """Under a schedule, each step of a stack reads the schedule's LR at its
    own step (current_learning_rate, as the host wrote it, equal to
    make_lr_schedule's value: the parent's reading); a chosen optimizer's
    device LR is that value in f32, its count the update count."""
    from recommendflow_tpu_torch.train.optimizers import make_lr_schedule
    from recommendflow_tpu_torch.train.trainer import (current_learning_rate,
                                                       make_optimizer)
    cosine = {"type": "cosine", "warmup_steps": 2, "decay_steps": 6}
    sched = make_lr_schedule(1e-3, **cosine)      # demo_trainer's peak LR
    for kw in ({"lr_schedule": cosine},
               {"optimizer": make_optimizer(sched, "adamw",
                                            weight_decay=1e-4)}):
        t = tp.demo_trainer(NETS, **kw)
        seen = []
        real = t._device_step

        def device_step(state, batch, real=real, seen=seen):
            opt = state.optimizer
            seen.append((current_learning_rate(state),
                         float(opt._lr) if hasattr(opt, "_lr") else None,
                         getattr(opt, "count", None)))
            return real(state, batch)
        t._device_step = device_step
        t.fit(tp.demo_batches(6, seed=79), epochs=1, scan_steps=4,
              verbose=False)
        assert [s[0] for s in seen] == [sched(i) for i in range(6)]
        if "optimizer" in kw:
            assert [s[1] for s in seen] == [
                float(np.float32(sched(i))) for i in range(6)]
            assert [s[2] for s in seen] == list(range(1, 7))


def test_lr_scale_through_a_device_lr():
    """ReduceLROnPlateau's lever (control["lr_scale"], applied by fit at an
    epoch's start) and set_learning_rate write an LR kept in a device tensor
    (the card's capturable Adam) in place, and current_learning_rate reads
    the host's value exactly, as the parent reads its float."""
    from recommendflow_tpu_torch.train.checkpoint import HOST_LR
    from recommendflow_tpu_torch.train.trainer import (current_learning_rate,
                                                       set_learning_rate)
    t = tp.demo_trainer(NETS)
    t.control["lr_scale"] = 0.3
    r = t.fit(tp.demo_batches(2, seed=80), epochs=1, verbose=False)
    assert current_learning_rate(r["state"]) == 1e-3 * 0.3
    state = r["state"]
    lr = torch.tensor(1e-3)
    dense = state.optimizer.param_groups[0]["params"]
    state.optimizer = torch.optim.Adam(dense, lr=lr, capturable=True)
    set_learning_rate(state, 0.1)
    group = state.optimizer.param_groups[0]
    assert group["lr"] is lr and float(lr) == float(np.float32(0.1))
    assert group[HOST_LR] == 0.1 and current_learning_rate(state) == 0.1


# ------------------------------------------------------------ checkpoints
def _card_form(saved):
    """A CPU checkpoint as the card's trainer writes it: the capturable
    Adam's groups with the LR in a tensor beside its host copy, each step
    an f32 tensor."""
    from recommendflow_tpu_torch.train.checkpoint import HOST_LR
    saved = dict(saved, optimizer=dict(saved["optimizer"]))
    groups = []
    for g in saved["optimizer"]["param_groups"]:
        groups.append(dict(g, lr=torch.tensor(g["lr"], dtype=torch.float32),
                           capturable=True, **{HOST_LR: g["lr"]}))
    saved["optimizer"]["param_groups"] = groups
    saved["optimizer"]["state"] = {
        i: dict(st, step=st["step"].to(torch.float32))
        for i, st in saved["optimizer"]["state"].items()}
    return saved


def test_a_card_checkpoint_loads_and_trains_on_the_cpu(tmp_path):
    """A checkpoint in the card's form loads into the CPU's plain Adam: the
    group not capturable, the LR the host's float exactly, the steps on the
    host; two more steps equal the uninterrupted run bitwise."""
    from recommendflow_tpu_torch.train.checkpoint import (HOST_LR,
                                                          restore_checkpoint)
    batches = tp.demo_batches(4, seed=81).batches
    t = tp.demo_trainer(NETS)
    s = t.init_state(batches[0])
    for b in batches[:2]:
        s, _ = t.train_step(s, b)
    path = str(tmp_path / "2.pt")
    torch.save(_card_form(_snapshot(s)), path)
    for b in batches[2:]:
        s, _ = t.train_step(s, b)
    t2 = tp.demo_trainer(NETS)
    s2 = restore_checkpoint(path, t2.init_state(batches[0]))
    group = s2.optimizer.param_groups[0]
    assert group["capturable"] is False and HOST_LR not in group
    assert isinstance(group["lr"], float) and group["lr"] == 1e-3
    assert all(st["step"].device.type == "cpu"
               for st in s2.optimizer.state.values())
    for b in batches[2:]:
        s2, _ = t2.train_step(s2, b)
    _assert_bitwise(_snapshot(s), _snapshot(s2))


def test_checkpoints_load_into_the_card_form_in_place(tmp_path):
    """A checkpoint in the parent's form (the plain Adam: LR a float, step
    on the host) and one in the card's form load into a capturable Adam with
    its LR in a tensor: into the optimizer's own tensors (a captured step
    reads them), the LR tensor the same object holding the LR in f32, the
    host's copy exact, the steps f32 beside their parameters; and the
    card's form round-trips bitwise."""
    from recommendflow_tpu_torch.train.checkpoint import (HOST_LR, load_state,
                                                          read_checkpoint,
                                                          save_checkpoint)
    batches = tp.demo_batches(3, seed=82).batches
    t = tp.demo_trainer(NETS)
    s = t.init_state(batches[0])
    for b in batches:
        s, _ = t.train_step(s, b)
    parent = _snapshot(s)
    t2 = tp.demo_trainer(NETS)
    s2 = t2.init_state(batches[0])
    lr = torch.tensor(5.0)
    dense = s2.optimizer.param_groups[0]["params"]
    s2.optimizer = torch.optim.Adam(dense, lr=lr, capturable=True)
    load_state(s2, parent)                         # creates the state
    before = {id(p): {k: v for k, v in st.items()}
              for p, st in s2.optimizer.state.items()}
    load_state(s2, _card_form(parent))             # into those tensors
    group = s2.optimizer.param_groups[0]
    assert group["lr"] is lr and float(lr) == float(np.float32(1e-3))
    assert group[HOST_LR] == 1e-3 and group["capturable"] is True
    for p, st in s2.optimizer.state.items():
        for k, v in st.items():
            assert v is before[id(p)][k], k
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 3
    for i, st in parent["optimizer"]["state"].items():
        p = dense[i]
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s2.optimizer.state[p][k], st[k]), k
    path = save_checkpoint(str(tmp_path / "c.pt"), s2)
    back = read_checkpoint(path)
    assert back["optimizer"]["param_groups"][0][HOST_LR] == 1e-3
    load_state(s2, back)
    _assert_bitwise(_snapshot(s2), back)
