"""A chosen optimizer and the `dice` activation on a mesh of two gloo
processes, against the JAX Trainer on a mesh of 2 fake CPU devices (pjit
over the global batch, every optimizer leaf sharded like its parameter, so
XLA computes each norm and each batch statistic over the global array).

  * `make_optimizer` (adam and adagrad with a clip_norm that binds at every
    step, lamb) on Mmoe under `shard_experts` (a ('dp', 'ep') mesh of (1,
    2): each rank holds 2 of 4 experts), and `make_partitioned_optimizer`
    with a binding clip_norm on Dssm under `shard_tables` (the dim-16
    group row-sharded over 'dp'): the global norm and lamb's |p| and |u|
    span every block;
  * a checkpoint of those runs saved at world 2 holds the whole optimizer
    state and resumes at world 2 and at world 1;
  * Dnn(activation="dice") on demo_ranking at world 2: dice standardizes
    over the global batch.

Both sides start from the same flax variables (the JAX init) and take the
same global batches (each port rank its contiguous rows) at dropout 0:
the losses within RTOL = 1e-6 relative, and each variable after the steps
within RTOL of its largest magnitude plus its optimizer's NOISE. That
floor is the same f32 arithmetic summed over another partition: Adam's
and lamb's u ~ g / (|g| + eps) turn a gradient's last-bit noise near eps
into up to 2.5e-6 on a table row after 3 steps (mmoe-adam-clip; lamb
3.5e-7, Dssm 5.9e-7, dice 1.2e-6), Adagrad's g / sqrt(acc) into 2.3e-10.
A norm or a batch statistic taken over one block instead of the whole
moves some leaf of every case by far more: by 3.5e-4 (adam with a clip),
7.9e-4 (lamb), 8.0e-6 (adagrad with a clip), 4.5e-3 (Dssm) and 5.0e-3
(dice) where each norm or mean is the rank's own.
A checkpoint resumed at world 2 ends bitwise as the uninterrupted run; at
world 1 its variables hold to the same bound and its optimizer state to
STATE_RTOL of each leaf's largest magnitude (the moments are gradient
sums in another partition: up to 1.2e-6 measured, on a BatchNorm bias's
first moment), its restored state equal to the file's.
"""
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_dist_tasks as tasks
import _torch_parity as tp

RTOL = 1e-6
# the absolute noise a leaf may carry beyond RTOL, by the optimizer that
# moves it: the sound runs' leaves reach at most 0.49 of the bound
# (Adagrad 0.004), each case's fault 64x (adam with a clip) to 955x (dice)
NOISE = {"adam": 5e-6, "adagrad": 1e-8}
STATE_RTOL = 5e-6
RANK_CONF = f"{tp.ROOT}/conf/demo_ranking.yaml"
PKG = "recommendflow_tpu.models"
MMOE = (f"{PKG}.ranking.mmoe.Mmoe",
        {"expert_units": (64, 32), "tower_units": (16,), "num_experts": 4,
         "dropout": 0.0}, RANK_CONF, {"table_dtype": "float32"},
        ("dp", "ep"), (1, 2), False, True)
DSSM = (f"{PKG}.matching.dssm.Dssm", {"dropout": 0.0}, tp.DEMO_CONF,
        {"tower_units": [64, 32], "table_dtype": "float32"}, ("dp",), (2,),
        True, False)
DICE = (f"{PKG}.ranking.dnn.Dnn", {"hidden_units": [64, 32],
                                   "activation": "dice", "dropout": 0.0},
        RANK_CONF, {"table_dtype": "float32"}, ("dp",), (2,), False, False)
# (case id, model, optimizer, clip_norm below every step's global norm)
CASES = [
    ("mmoe-adam-clip", MMOE, dict(optimizer="adam", clip_norm=0.05)),
    ("mmoe-lamb", MMOE, dict(optimizer="lamb", weight_decay=1e-4)),
    ("mmoe-adagrad-clip", MMOE, dict(optimizer="adagrad", clip_norm=0.05)),
    ("dssm-partitioned-clip", DSSM, dict(partitioned=True,
                                          dense_optimizer="adam",
                                          clip_norm=0.5)),
]


@pytest.fixture(scope="module")
def pool2(request, tmp_path_factory):
    return _torch_dist.make_pool(request, tmp_path_factory, 2)


def _batches(conf_path, networks, n, seed):
    from recommendflow_tpu.data.schema import compile_schema
    from recommendflow_tpu.data.synthetic import synthetic_batch
    jc, _ = tp.conf_pair(conf_path, networks)
    return [synthetic_batch(compile_schema(jc.features), 64, seed=seed + i)
            for i in range(n)]


def _norm_recorder():
    """An optax transformation that passes the updates on and keeps their
    global norm in its state (the norm the clip reads)."""
    import jax.numpy as jnp
    import optax

    def init(params):
        return {"norm": jnp.zeros((), jnp.float32)}

    def update(updates, state, params=None):
        return updates, {"norm": optax.global_norm(updates)}
    return optax.GradientTransformation(init, update)


def _scale_upper_experts(params):
    """Every expert leaf's upper half of experts x 3: the two ranks' blocks
    then differ in scale, so a norm over one block (lamb's trust ratio, the
    clip's global norm) is not the whole leaf's."""
    import jax
    import jax.numpy as jnp

    def scale(path, x):
        if "experts" not in [str(getattr(k, "key", k)) for k in path]:
            return x
        n = x.shape[0]
        f = jnp.where(jnp.arange(n) >= n // 2, 3.0, 1.0).astype(x.dtype)
        return x * f.reshape((n,) + (1,) * (x.ndim - 1))
    return jax.tree_util.tree_map_with_path(scale, params)


def _jax_tx(opt):
    import optax
    from recommendflow_tpu.train.optimizers import make_partitioned_optimizer
    from recommendflow_tpu.train.trainer import make_optimizer
    opt = dict(opt)
    make = make_partitioned_optimizer if opt.pop("partitioned", False) \
        else make_optimizer
    return optax.chain(_norm_recorder(), make(1e-3, **opt))


def _jax_run(model, opt, batches):
    """The JAX Trainer on 2 fake devices from its init: (the init
    variables, losses, the clip's global norm at each step (None without
    a chosen optimizer), the variables after the steps, flat)."""
    import jax
    from recommendflow_tpu.models.base import build_network
    from recommendflow_tpu.parallel.mesh import make_mesh
    from recommendflow_tpu.train.trainer import Trainer
    path, kw, conf_path, networks, axes, shape, shard_t, shard_e = model
    jc, _ = tp.conf_pair(conf_path, networks)
    jm, _ = build_network(path, {"conf": jc, **kw})
    extra = {} if opt is None else {"optimizer": _jax_tx(opt)}
    t = Trainer(jm, learning_rate=1e-3, table_update="split", seed=0,
                mesh=make_mesh(jax.devices()[:2], axes, shape),
                shard_tables=shard_t, shard_experts=shard_e, **extra)
    state = t.init_state(t._put(batches[0]))
    if shard_e:
        state = state.replace(params=_scale_upper_experts(state.params))
    if t._split_dims:
        t._split_dims = {d: "sparse_set" for d in t._split_dims}
    variables = {"params": tp._nested(state.params),
                 "batch_stats": tp._nested(state.batch_stats)}
    losses, norms = [], []
    for b in batches:
        state, m = t.train_step(state, b)
        losses.append(float(m["loss"]))
        if opt is not None:
            norms.append(float(state.opt_state[0]["norm"]))
    final = tp.flat_tree({"params": tp._nested(state.params),
                          "batch_stats": tp._nested(state.batch_stats)})
    return variables, losses, norms, final


def _rel(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)) \
        if b.size else 0.0


def _abs(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) if b.size else 0.0


def _noise(opt):
    """The NOISE floor of a case's optimizer (the Trainer's default, Adam,
    where none is chosen)."""
    opt = opt or {}
    return NOISE["adagrad" if opt.get("optimizer") == "adagrad" else "adam"]


def _hold(got, want, what, noise, rtol=RTOL):
    """Every leaf of `got` within rtol of the leaf's largest magnitude in
    `want` plus `noise`."""
    got = {k: v for k, v in tp.flat_tree(got).items()}
    assert sorted(got) == sorted(want), what
    for k, b in want.items():
        err = _abs(got[k], b)
        tol = rtol * np.abs(np.asarray(b, np.float64)).max(initial=0.0) \
            + noise
        assert err <= tol, f"{what}: {k} {err} > {tol}"


def _run(pool, model, opt, batches, variables):
    path, kw, conf_path, networks, axes, shape, shard_t, shard_e = model
    return pool.run(tasks.mesh_model_steps, path, kw, conf_path, networks,
                    variables, opt, batches, axes, shape, shard_t, shard_e)


@pytest.mark.parametrize("case,model,opt", CASES, ids=[c[0] for c in CASES])
def test_chosen_optimizer_on_a_mesh_matches_jax(case, model, opt, pool2):
    batches = _batches(model[2], model[3], 3, seed=120)
    variables, jl, norms, jfin = _jax_run(model, opt, batches)
    if "clip_norm" in opt:        # the clip binds: it scales every step
        assert min(norms) > opt["clip_norm"], norms
    got = _run(pool2, model, opt, batches, variables)
    for rank, (tl, fin, blocks, digests) in enumerate(got):
        assert blocks, "no row block: the mesh shards nothing"
        assert digests == got[0][3], f"rank {rank}: replicas differ"
        assert _rel(tl, jl) <= RTOL, (tl, jl)
        _hold(fin, jfin, f"{case} rank {rank}", _noise(opt))


def test_dice_on_a_mesh_takes_the_global_batch(pool2):
    """Dnn with dice between its layers: each rank's rows standardized by
    the global batch's mean and variance, as JAX under pjit."""
    batches = _batches(DICE[2], DICE[3], 3, seed=140)
    variables, jl, _, jfin = _jax_run(DICE, None, batches)
    got = pool2.run(tasks.mesh_model_steps, *DICE[:4], variables, None,
                    batches, *DICE[4:])
    for rank, (tl, fin, _, digests) in enumerate(got):
        assert digests == got[0][3], f"rank {rank}: replicas differ"
        assert _rel(tl, jl) <= RTOL, (tl, jl)
        _hold(fin, jfin, f"dice rank {rank}", _noise(None))


def _single_resume(model, opt, variables, batches, file, steps_before):
    """World 1 in this process, no mesh: restore the world-2 file, take the
    remaining global batches. (optimizer state at the restore, final)."""
    from recommendflow_tpu_torch.train.checkpoint import restore_checkpoint
    path, kw, conf_path, networks = model[:4]
    t = tasks.mesh_model_trainer(path, kw, conf_path, networks, variables,
                                 opt)
    state = t.init_state(batches[0])
    restore_checkpoint(file, state)
    at = tasks._whole_state(state)[1]
    for b in batches[steps_before:]:
        state, _ = t.train_step(state, b)
    return at, tasks._whole_state(state), state.step


def _same_opt(a, b, what):
    assert sorted(a) == sorted(b), what
    for n in a:
        assert sorted(a[n]) == sorted(b[n]), (what, n)
        for k in a[n]:
            assert a[n][k].shape == b[n][k].shape, (what, n, k)
            np.testing.assert_array_equal(a[n][k], b[n][k],
                                          err_msg=f"{what}: {n}/{k}")


@pytest.mark.parametrize("case", [CASES[0], CASES[3]],
                         ids=[CASES[0][0], CASES[3][0]])
def test_chosen_optimizer_checkpoint_crosses_world_sizes(case, pool2,
                                                         tmp_path):
    """Saved at world 2 after 2 of 4 steps: the file holds the whole
    optimizer state (each block's moments or accumulators gathered), a
    restore at world 2 and at world 1 puts it back whole, and the resumed
    runs end as the uninterrupted one: bitwise at world 2; at world 1 (the
    global batch's sums in another partition) the variables within RTOL
    plus NOISE and the optimizer state within STATE_RTOL, leaf by leaf."""
    _, model, opt = case
    path, kw, conf_path, networks, axes, shape, shard_t, shard_e = model
    batches = _batches(conf_path, networks, 4, seed=160)
    from recommendflow_tpu.models.base import build_network
    import jax
    jc, _ = tp.conf_pair(conf_path, networks)
    jm, _ = build_network(path, {"conf": jc, **kw})
    v = jm.init(jax.random.PRNGKey(0), tp.to_jax(batches[0]), training=False)
    if shard_e:
        v = dict(v, params=_scale_upper_experts(v["params"]))
    variables = {"params": tp._nested(v["params"]),
                 "batch_stats": tp._nested(v.get("batch_stats", {}))}
    file = str(tmp_path / "w2.pt")
    args = (path, kw, conf_path, networks, variables, opt, batches, axes,
            shape, shard_t, shard_e, file, 2)
    saved = pool2.run(tasks.mesh_model_ckpt, *args, "save")
    (at_save, (vars2, opt2), step2) = saved[0]
    assert step2 == 4
    whole = torch.load(file, weights_only=True)["optimizer"]["state"]
    on_file = {n: {k: tasks._np(t) for k, t in st.items()}
               for n, st in whole.items()}
    _same_opt(at_save, on_file, "saved")
    resumed = pool2.run(tasks.mesh_model_ckpt, *args, "resume")
    single = _single_resume(model, opt, variables, batches, file, 2)
    for what, (at, (fvars, fopt), step) in [("world 2", resumed[0]),
                                            ("world 1", single)]:
        assert step == 4, what
        _same_opt(at, on_file, f"{what} restored")
        exact = what == "world 2"
        _hold(fvars, tp.flat_tree(vars2), what,
              0.0 if exact else _noise(opt), 0.0 if exact else RTOL)
        _hold({f"{n}/{k}": v for n, st in fopt.items() for k, v in st.items()},
              {f"{n}/{k}": v for n, st in opt2.items() for k, v in st.items()},
              f"{what} optimizer state", 0.0, 0.0 if exact else STATE_RTOL)
