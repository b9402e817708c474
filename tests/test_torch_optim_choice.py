"""The optimizer family and the LR schedules against the JAX package's.

  * `make_optimizer` (adam, adamw, adagrad, sgd, lamb; with and without
    clip_norm) and `make_partitioned_optimizer` (adam, adamw, sgd on the
    dense leaves, row-wise Adagrad on a table) as the port's OptaxOptimizer
    against the optax transformations the JAX package builds, over 5
    updates of the same f32 leaves and gradients (numpy, seeded), one leaf
    at zero (lamb's trust ratio is 1 there) and one step with a zero
    gradient leaf. Every leaf after every update within rtol 1e-6 plus
    atol 5e-7 [measured worst 1.04e-7, adam with the clip]: the same f32
    operations, with the clip's global norm and lamb's norms summed in
    another order; 5e-7 is 5e-5 of one update (lr 0.01).
  * `make_lr_schedule` against the optax schedule at every count from 0 to
    30: within 1e-6 of the peak (optax evaluates in f32, the port in f64).
  * `Trainer(optimizer=...)` and `Trainer(lr_schedule=...)` for three Dssm
    steps on conf/demo_recall.yaml (f32 tables, dropout 0, batches of 64,
    the JAX init weights carried by interop) against the JAX Trainer: the
    injected LR after every step (current_learning_rate) equal, the losses
    within rtol 1e-5 [measured 1.3e-7] and every weight within atol 2e-6
    [measured worst 3.1e-7, adam with the clip]: the same f32 arithmetic
    summed in another order, a few f32 ulps of weights of magnitude ~1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parity as tp
from recommendflow_tpu_torch import interop

LEAVES = {"dense/kernel": (6, 5), "dense/bias": (5,), "zero": (4,),
          "embedder/table_dim16": (12, 16)}
SPECS = [("adam", {}), ("adamw", {"weight_decay": 0.01}), ("adagrad", {}),
         ("sgd", {}), ("lamb", {"weight_decay": 0.01})]


def _leaves(seed):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in LEAVES.items()}
    params["zero"][:] = 0.0
    grads = []
    for step in range(5):
        g = {k: (rng.randn(*s) * 0.5).astype(np.float32)
             for k, s in LEAVES.items()}
        if step == 2:
            g["dense/bias"][:] = 0.0
        grads.append(g)
    return params, grads


def _tree(flat):
    return interop.unflatten({tuple(k.split("/")): jnp.asarray(v)
                              for k, v in flat.items()})


def _compare(jax_tx, port_spec, seed=0):
    params, grads = _leaves(seed)
    jp = _tree(params)
    js = jax_tx.init(jp)
    named = [(k.replace("/", "."), torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in params.items()]
    opt = port_spec.build(named)
    for g in grads:
        upd, js = jax_tx.update(_tree(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for (name, p), k in zip(named, params):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        flat = {"/".join(k): np.asarray(v)
                for k, v in interop.flatten(jax.device_get(jp)).items()}
        for (name, p), k in zip(named, params):
            np.testing.assert_allclose(p.detach().numpy(), flat[k], rtol=1e-6,
                                       atol=5e-7, err_msg=k)


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["noclip", "clip1"])
@pytest.mark.parametrize("name,kw", SPECS, ids=[s[0] for s in SPECS])
def test_make_optimizer_matches_optax(name, kw, clip):
    from recommendflow_tpu.train.trainer import make_optimizer as jax_make
    from recommendflow_tpu_torch.train.trainer import make_optimizer
    _compare(jax_make(0.01, name, clip_norm=clip, **kw),
             make_optimizer(0.01, name, clip_norm=clip, **kw))


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["noclip", "clip1"])
@pytest.mark.parametrize("dense", ["adam", "adamw", "sgd"])
def test_make_partitioned_optimizer_matches_optax(dense, clip):
    """The table leaf takes row-wise Adagrad at the fixed table LR (kernel
    4's plain version here), the rest the dense optimizer; the clip's
    global norm spans both."""
    from recommendflow_tpu.train.optimizers import \
        make_partitioned_optimizer as jax_make
    from recommendflow_tpu_torch.train.optimizers import (
        make_partitioned_optimizer)
    kw = {"weight_decay": 0.01} if dense == "adamw" else {}
    _compare(jax_make(0.01, table_learning_rate=0.05, dense_optimizer=dense,
                      clip_norm=clip, **kw),
             make_partitioned_optimizer(0.01, table_learning_rate=0.05,
                                        dense_optimizer=dense, clip_norm=clip,
                                        **kw))


def test_the_clip_acts_only_past_the_norm():
    """Gradients of global norm below clip_norm pass unchanged; above it
    they are scaled to it (on the device, no host read)."""
    from recommendflow_tpu_torch.train.optimizers import _clip_by_global_norm
    g = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0])}
    same = _clip_by_global_norm(g, 10.0)
    assert torch.equal(same["a"], g["a"])
    cut = _clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(cut["a"].numpy(), [0.6, 0.8], rtol=1e-6)


SCHEDULES = [dict(type=t, warmup_steps=w, decay_steps=d, min_ratio=m)
             for t in ("cosine", "linear", "warmup_constant")
             for w, d, m in ((0, 20, 0.0), (3, 20, 0.1), (5, 10, 0.0))]


@pytest.mark.parametrize("kw", SCHEDULES, ids=[
    f"{s['type']}-w{s['warmup_steps']}-d{s['decay_steps']}-m{s['min_ratio']}"
    for s in SCHEDULES])
def test_make_lr_schedule_matches_optax(kw):
    from recommendflow_tpu.train.optimizers import make_lr_schedule as jax_make
    from recommendflow_tpu_torch.train.optimizers import make_lr_schedule
    peak = 3e-3
    want = jax_make(peak, **kw)
    got = make_lr_schedule(peak, **kw)
    for count in range(31):
        assert abs(got(count) - float(want(jnp.asarray(count, jnp.int32)))) \
            <= 1e-6 * peak, (kw, count)
    if kw["warmup_steps"]:
        assert got(0) == 0.0


def test_a_cosine_schedule_needs_decay_steps():
    from recommendflow_tpu_torch.train.optimizers import make_lr_schedule
    with pytest.raises(ValueError, match="decay_steps"):
        make_lr_schedule(1e-3, "cosine", decay_steps=0)
    with pytest.raises(ValueError, match="schedule"):
        make_lr_schedule(1e-3, "step")


# ------------------------------------------------- three trainer steps
NETS = {"tower_units": [64, 32], "table_dtype": "float32"}


def _world():
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    jc, tc = tp.conf_pair(networks=NETS)
    batches = [synthetic_batch(compile_schema(jc.features), 64, seed=70 + i)
               for i in range(3)]
    return jc, tc, batches


def _three_steps(jax_kw, port_kw):
    """(JAX (losses, lrs, flat variables), port's) after three steps from
    the same init weights."""
    from recommendflow_tpu.models.base import build_network as jbuild
    from recommendflow_tpu.train.trainer import Trainer as JTrainer
    from recommendflow_tpu.train.trainer import current_learning_rate as jlr
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import (Trainer,
                                                       current_learning_rate)
    jc, tc, batches = _world()
    jm, _ = jbuild(jc.networks["class"], {"conf": jc, "dropout": 0.0})
    jt = JTrainer(jm, seed=0, **jax_kw)
    js = jt.init_state(jt._put(batches[0]))
    tm, _ = build_network(tc.networks["class"],
                          {"conf": tc, "dropout": 0.0, "device": "cpu"})
    interop.load_jax_variables(tm, {"params": tp._nested(js.params),
                                    "batch_stats": tp._nested(js.batch_stats)})
    tt = Trainer(tm, device="cpu", **port_kw)
    ts = tt.init_state(batches[0])
    assert jlr(js) == pytest.approx(current_learning_rate(ts), rel=1e-6)
    out = {"jax": ([], []), "port": ([], [])}
    for b in batches:
        js, jm_ = jt.train_step(js, b)
        ts, tm_ = tt.train_step(ts, b)
        out["jax"][0].append(float(jm_["loss"]))
        out["jax"][1].append(jlr(js))
        out["port"][0].append(float(tm_["loss"]))
        out["port"][1].append(current_learning_rate(ts))
    jflat = tp.flat_tree({"params": tp._nested(js.params),
                          "batch_stats": tp._nested(js.batch_stats)})
    tflat = tp.flat_tree(interop.jax_from_variables(tm.state_dict()))
    return out, jflat, tflat, tt


def _hold(out, jflat, tflat):
    (jl, jlrs), (tl, tlrs) = out["jax"], out["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tlrs, jlrs, rtol=1e-6)
    assert sorted(jflat) == sorted(tflat)
    for k, a in jflat.items():
        np.testing.assert_allclose(tflat[k], a, rtol=0, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("name,kw", SPECS + [("adam", {"clip_norm": 1.0})],
                         ids=[s[0] for s in SPECS] + ["adam-clip1"])
def test_trainer_with_make_optimizer_matches_jax(name, kw):
    from recommendflow_tpu.train.trainer import make_optimizer as jax_make
    from recommendflow_tpu_torch.train.trainer import make_optimizer
    out, jflat, tflat, tt = _three_steps(
        {"optimizer": jax_make(1e-3, name, **kw)},
        {"optimizer": make_optimizer(1e-3, name, **kw)})
    # a given optimizer takes no split and no touched-row path
    assert not tt._split_dims and not tt._sparse_dims
    _hold(out, jflat, tflat)


def test_trainer_with_make_partitioned_optimizer_matches_jax():
    from recommendflow_tpu.train.optimizers import \
        make_partitioned_optimizer as jax_make
    from recommendflow_tpu_torch.train.optimizers import (
        make_partitioned_optimizer)
    out, jflat, tflat, _ = _three_steps(
        {"optimizer": jax_make(1e-3, dense_optimizer="adamw",
                               weight_decay=0.01, clip_norm=1.0)},
        {"optimizer": make_partitioned_optimizer(
            1e-3, dense_optimizer="adamw", weight_decay=0.01, clip_norm=1.0)})
    _hold(out, jflat, tflat)


def test_trainer_with_an_lr_schedule_matches_jax():
    """The default optimizer under a warmup + cosine schedule (the split
    path): the first step at LR 0, the injected LR each step optax's."""
    sched = {"type": "cosine", "warmup_steps": 2, "decay_steps": 4,
             "min_ratio": 0.1}
    out, jflat, tflat, tt = _three_steps(
        {"learning_rate": 2e-3, "lr_schedule": sched},
        {"learning_rate": 2e-3, "lr_schedule": sched})
    assert out["port"][1][0] == 0.0 and tt._split_dims
    _hold(out, jflat, tflat)


def test_a_schedule_outlives_set_learning_rate():
    """While a schedule is active set_learning_rate (ReduceLROnPlateau's
    lever) changes nothing past the next step; without one it holds."""
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.train.optimizers import make_lr_schedule
    from recommendflow_tpu_torch.train.trainer import (Trainer,
                                                       current_learning_rate,
                                                       set_learning_rate)
    _, tc, batches = _world()
    sched = dict(type="linear", decay_steps=10)
    t = Trainer(Dssm(tc, device="cpu"), learning_rate=1e-2,
                lr_schedule=sched, device="cpu")
    state = t.init_state(batches[0])
    set_learning_rate(state, 5.0)
    state, _ = t.train_step(state, batches[1])
    assert current_learning_rate(state) == make_lr_schedule(1e-2, **sched)(0)
    t2 = Trainer(Dssm(tc, device="cpu"), learning_rate=1e-2, device="cpu")
    state2 = t2.init_state(batches[0])
    t2.set_learning_rate(state2, 5e-3)
    state2, _ = t2.train_step(state2, batches[1])
    assert current_learning_rate(state2) == 5e-3
    assert t.table_lr == t2.table_lr == 0.3        # default_table_lr(1e-2)


def test_a_chosen_optimizer_through_a_checkpoint(tmp_path):
    """OptaxOptimizer's state (count, injected LR, moments) goes through
    save_checkpoint / restore_checkpoint bit for bit: the restored state's
    next step equals the original's. interop's training-state tree, which
    carries the default Adam's moments, refuses it."""
    from recommendflow_tpu_torch.models.matching.dssm import Dssm
    from recommendflow_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)
    from recommendflow_tpu_torch.train.trainer import (Trainer,
                                                       current_learning_rate,
                                                       make_optimizer)
    _, tc, batches = _world()

    def trainer():
        torch.manual_seed(0)
        spec = make_optimizer(lambda c: 1e-3 / (1 + c), "adamw",
                              weight_decay=1e-2, clip_norm=1.0)
        return Trainer(Dssm(tc, dropout=0.0, device="cpu"), optimizer=spec,
                       device="cpu")

    t = trainer()
    state = t.init_state(batches[0])
    state, _ = t.train_step(state, batches[0])
    path = save_checkpoint(str(tmp_path / "c.pt"), state)
    t2 = trainer()
    state2 = restore_checkpoint(path, t2.init_state(batches[0]))
    assert state2.optimizer.count == 1 and current_learning_rate(state2) == 1e-3
    state, m = t.train_step(state, batches[1])
    state2, m2 = t2.train_step(state2, batches[1])
    assert float(m["loss"]) == float(m2["loss"])
    assert current_learning_rate(state2) == current_learning_rate(state) == 5e-4
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              state2.model.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(TypeError, match="Adam"):
        interop.train_state_tree(state)
