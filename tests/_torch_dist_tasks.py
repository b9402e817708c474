"""Functions the gloo worker processes of tests/_torch_dist.py run: torch
only (the JAX references run in the pytest process). Each takes (rank,
world, *args) and returns numpy arrays or plain values."""
import numpy as np
import torch

from recommendflow_tpu_torch.parallel.mesh import make_mesh


def _t(a):
    """numpy (f32, int or ml_dtypes bf16) -> tensor, bf16 by its bits."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class _Group:
    def __init__(self, dim):
        self.dim = dim


# ------------------------------------------------------------- mesh, rules
def mesh_layout(rank, world, axes, shape):
    m = make_mesh(axes, shape)
    return dict(m.shape), {a: m.rank(a) for a in axes}


def sharding_rules(rank, world, shapes, axes, shape, kind):
    from recommendflow_tpu_torch.parallel import mesh as pm
    m = make_mesh(axes, shape)
    params = {k: torch.zeros(v) for k, v in shapes.items()}
    try:
        if kind == "table":
            return {k: tuple(v) for k, v in
                    pm.table_sharding_rules(params, m).items()}
        if kind == "expert":
            return {k: tuple(v) for k, v in
                    pm.expert_sharding_rules(params, m).items()}
        merged = pm.merge_rules(pm.table_sharding_rules(params, m, "dp", 8),
                                pm.expert_sharding_rules(params, m))
        placed = pm.apply_shardings(params, m, merged)
        return ({k: tuple(v) for k, v in merged.items()},
                {k: tuple(v.shape) for k, v in placed.items()})
    except ValueError as e:
        return f"ValueError: {e}"


def shard_batch(rank, world, batch):
    from recommendflow_tpu_torch.parallel.mesh import shard_batch as sb
    return sb(make_mesh(), batch)


def collectives(rank, world):
    from recommendflow_tpu_torch.parallel.distributed import (
        all_gather, all_reduce_sum, host_id, num_hosts)
    m = make_mesh()
    g = m.group("dp")
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    y = all_gather(x, g)
    (y * torch.arange(2 * world, dtype=torch.float32)[:, None]).sum().backward()
    z = torch.full((3,), float(rank + 1), requires_grad=True)
    s = all_reduce_sum(z, g)
    (s * (rank + 1)).sum().backward()
    return (_np(y), _np(x.grad), _np(s), _np(z.grad), host_id(), num_hosts())


# ------------------------------------------------------- sharded embedding
def sharded_gather(rank, world, table, dim, gids, w):
    from recommendflow_tpu_torch.parallel.sharded_embedding import (
        gather_local_rows, mark_row_shard, shard_tables, sharded_gather_group)
    m = make_mesh()
    full = _t(table)
    shard = shard_tables({"dim16": full, "img_x": torch.zeros(192, 16)},
                         m)
    assert shard["img_x"].shape == (192, 16)
    t = shard["dim16"].clone().requires_grad_()
    ids = torch.from_numpy(gids)
    rows = sharded_gather_group(m, "dp", t, _Group(dim), ids)
    (rows * torch.from_numpy(w)).sum().backward()
    # the embed pass's form: this rank's ids of the batch
    p = torch.nn.Parameter(full.clone())
    mark_row_shard(p, m, "dp")
    b = gids.shape[0] // world
    local = gather_local_rows(p, p.row_shard, _Group(dim),
                              ids[rank * b:(rank + 1) * b])
    (local * torch.from_numpy(w[rank * b:(rank + 1) * b])).sum().backward()
    return (_np(rows), rows.dtype == torch.float32, _np(t.grad),
            _np(local), _np(p.grad), tuple(p.shape))


def embed_pass(rank, world, conf_path, tables, dim, batch, w):
    """`embed_batch` of this rank's rows of `batch` with the dim-`dim`
    table row-sharded (`mark_row_shard`) and the others whole, under a CPU
    profiler, and the backward of sum(out[n] * w[n]) over the slots of `w`:
    (every slot's output, the block's gradient, the `shard.*` spans'
    counts)."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    from recommendflow_tpu_torch.ops.embedding import embed_batch
    from recommendflow_tpu_torch.parallel.sharded_embedding import \
        mark_row_shard
    from recommendflow_tpu_torch.utils import profiling
    m = make_mesh()
    schema = compile_schema(Configuration(conf_path).features)
    params = {k: _t(v) for k, v in tables.items()}
    p = torch.nn.Parameter(params[f"dim{dim}"])
    mark_row_shard(p, m, "dp")
    params[f"dim{dim}"] = p
    b = len(batch["label"]) // world
    mine = {k: torch.from_numpy(v[rank * b:(rank + 1) * b])
            for k, v in batch.items()}
    profiling._SPANS.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = embed_batch(params, schema, mine)
        sum((out[n] * torch.from_numpy(v[rank * b:(rank + 1) * b])).sum()
            for n, v in w.items()).backward()
    return ({n: _np(v) for n, v in out.items()}, _np(p.grad),
            [(s.name, dict(s.counts)) for s in profiling.spans()
             if s.name.startswith("shard.")])


# ---------------------------------------------------------- sharded search
def sharded_search(rank, world, spec, metric, corpus, queries, k, save=None,
                   load=None, kind="factory"):
    """index_factory(..., mesh=) over the corpus: (scores, ids, class name,
    this rank's block rows) of the queries; with `save` the index is saved
    there, with `load` it is loaded from there instead of trained; kind
    'pickle' searches after a pickle round trip."""
    import pickle
    from recommendflow_tpu_torch.retrieval import index_factory
    from recommendflow_tpu_torch.retrieval.sharded import (ShardedSearcher,
                                                           ShardedSqSearcher)
    mesh = make_mesh(("items",))
    if load is not None:
        cls = ShardedSqSearcher if spec.startswith("SQ") else ShardedSearcher
        s = cls.load(load, mesh=mesh)
    else:
        s = index_factory(corpus.shape[1], spec, metric, mesh=mesh)
        s.train(corpus)
    if kind == "pickle":
        s = pickle.loads(pickle.dumps(s))
    scores, ids = s.search(queries, k, return_items=False)
    if save is not None:
        s.save(save)
    block = s._codes if spec.startswith("SQ") else s._vecs
    return scores, ids, type(s).__name__, int(block.shape[0])


# ------------------------------------------------------ losses and metrics
def axis_loss(rank, world, name, y, q, d, logq, kwargs):
    """The loss `name` on this rank's rows with axis_name='dp': (value,
    gradients of the local query, doc and logq rows)."""
    from recommendflow_tpu_torch.losses import match as tm
    make_mesh()
    b = len(y) // world
    sl = slice(rank * b, (rank + 1) * b)
    tq = torch.from_numpy(q[sl]).requires_grad_()
    td = torch.from_numpy(d[sl]).requires_grad_()
    extra = dict(kwargs)
    tl = None
    if logq is not None:
        tl = torch.from_numpy(logq[sl]).requires_grad_()
        extra["logq"] = tl
    if name.startswith("global:"):
        fn = tm.global_batch_loss(getattr(tm, name[7:]), "dp")
        loss = fn(torch.from_numpy(y[sl]), tq, td)
    else:
        fn = getattr(tm, name)
        if name == "batch_softmax_probabilistic_combining_soft":
            fn = fn(len(y))
        loss = fn(torch.from_numpy(y[sl]), tq, td, axis_name="dp", **extra)
    loss.backward()
    return (float(loss), _np(tq.grad), _np(td.grad),
            None if tl is None else _np(tl.grad))


def axis_auc(rank, world, y, score):
    from recommendflow_tpu_torch.train import metrics as tm
    make_mesh()
    b = len(y) // world
    sl = slice(rank * b, (rank + 1) * b)
    s = tm.auc_update(tm.auc_init(device="cpu"), torch.from_numpy(y[sl]),
                      torch.from_numpy(score[sl]), axis_name="dp")
    return [_np(x) for x in s], float(tm.auc_result(s))


# ------------------------------------------------------------------ trainer
DEMO_CONF = __import__("os").path.join(__import__("os").path.dirname(
    __file__), "..", "conf", "demo_recall.yaml")


def _digest(t):
    import hashlib
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha1(t.numpy().tobytes()).hexdigest()


def replica_digests(state):
    """sha1 of every replicated weight, buffer, accumulator and Adam
    moment (a row block is its rank's own: left out)."""
    from recommendflow_tpu_torch.train.checkpoint import _acc_tables
    out = {}
    for name, p in state.model.named_parameters():
        if getattr(p, "row_shard", None) is None:
            out[name] = _digest(p)
    for name, b in state.model.named_buffers():
        out["buf/" + name] = _digest(b)
    tables = _acc_tables(state.model)
    for k, v in state.table_acc.items():
        if getattr(tables.get(k), "row_shard", None) is None:
            out["acc/" + k] = _digest(v)
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        if getattr(p, "row_shard", None) is None:
            for k, v in st.items():
                if isinstance(v, torch.Tensor):
                    out[f"opt/{name}/{k}"] = _digest(v)
    return out


def dp_trainer(networks, mode, strategy, shard, device="cpu", dropout=0.0,
               conf_path=DEMO_CONF, seed=0):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer
    conf = Configuration(conf_path)
    conf.networks.update(networks)
    model, _ = build_network(conf.networks["class"], {
        "conf": conf, "dropout": dropout, "device": device, "seed": seed})
    return Trainer(model, learning_rate=1e-3, table_update=mode,
                   split_strategy=strategy, device=device, mesh=make_mesh(),
                   shard_tables=shard)


def dp_steps(rank, world, networks, mode, strategy, shard, tree, batches):
    """Three steps of this rank's rows of each global batch from a carried
    training-state tree: (losses, the whole state tree (gathered), the
    replicas' digests, the planned split and touched-row dims, the row
    blocks' names)."""
    import ml_dtypes
    from recommendflow_tpu_torch import interop
    from recommendflow_tpu_torch.parallel.mesh import shard_batch
    t = dp_trainer(networks, mode, strategy, shard)
    local = [shard_batch(t.mesh, b) for b in batches]
    state = t.init_state(local[0])
    interop.load_train_state(state, tree)
    losses = []
    for b in local[1:]:
        state, m = t.train_step(state, b)
        losses.append(float(m["loss"]))
    sharded = sorted(n for n, p in t.model.named_parameters()
                     if getattr(p, "row_shard", None) is not None)
    return (losses, interop.flatten(interop.train_state_tree(
        state, ml_dtypes.bfloat16)), replica_digests(state),
        dict(t._split_dims), list(t._sparse_dims), sharded)


# ------------------------------------------- multi-process fit, preemption
class _Batches:
    """Fixed batches with a length and iter_from (as the record Dataset);
    with `kill_at` this process sends itself SIGTERM as it yields that
    batch."""

    def __init__(self, batches, kill_at=None):
        self.batches, self.kill_at = batches, kill_at

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, skip=0, epoch=0):
        import os
        import signal
        for i, b in enumerate(self.batches[skip:]):
            if self.kill_at is not None and i == self.kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b


def _demo_local(rank, world, n, seed, batch=32):
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    schema = compile_schema(Configuration(DEMO_CONF).features)
    out = []
    for i in range(n):
        b = synthetic_batch(schema, batch * world, seed=seed + i)
        out.append({k: v[rank * batch:(rank + 1) * batch]
                    for k, v in b.items()})
    return out


def fit_preempted(rank, world, kill_rank, kill_at, window, preempt_dir,
                  lengths, shard, epochs=1, scan_steps=1):
    """fit on this rank's batches (lengths[rank] of them); rank kill_rank
    sends itself SIGTERM as it draws batch kill_at (None: no signal).
    Returns (steps, preempted, epochs run, files under preempt_dir)."""
    import os
    import signal
    from recommendflow_tpu_torch.train.trainer import (
        install_preemption_handler)
    t = dp_trainer({"tower_units": [32]}, "sparse" if shard else "split",
                   "sparse_set", shard)
    batches = _demo_local(rank, world, lengths[rank], 60)
    ds = _Batches(batches, kill_at if rank == kill_rank else None)
    saved = install_preemption_handler(t)
    try:
        out = t.fit(ds, epochs=epochs, preempt_dir=preempt_dir,
                    preempt_window=window, scan_steps=scan_steps,
                    verbose=False)
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    files = sorted(os.listdir(preempt_dir)) if preempt_dir and \
        os.path.isdir(preempt_dir) else []
    return (out["state"].step, out["preempted"], len(out["history"]), files)


def ckpt_world(rank, world, shard, path, steps_before, steps_after, mode):
    """mode 'save': `steps_before` steps of the global batches from the
    start, save to `path`, then `steps_after` more; mode 'resume': restore
    `path` and take the `steps_after` steps. Returns the whole state tree
    after the steps (and, saving, the tree as saved)."""
    import ml_dtypes
    from recommendflow_tpu_torch import interop
    from recommendflow_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)
    t = dp_trainer({"tower_units": [32]}, "sparse", "auto", shard)
    batches = _demo_local(rank, world, steps_before + steps_after, 80,
                          batch=64 // world)
    state = t.init_state(batches[0])
    saved = None
    if mode == "save":
        for b in batches[:steps_before]:
            state, _ = t.train_step(state, b)
        save_checkpoint(path, state)
        saved = interop.flatten(interop.train_state_tree(
            state, ml_dtypes.bfloat16))
    else:
        restore_checkpoint(path, state)
    for b in batches[steps_before:]:
        state, _ = t.train_step(state, b)
    return interop.flatten(interop.train_state_tree(
        state, ml_dtypes.bfloat16)), saved, state.step


def train_cli(rank, world, data, root, extra):
    """cli/train on this rank (the group joined already, as under
    torchrun): (steps, the mesh's shape, the row blocks' names, the final
    history, the checkpoint file's dim-16 table shape)."""
    import os
    from recommendflow_tpu_torch.cli import train as cli
    result = cli.main([DEMO_CONF, "--data", data, "--train_mode", "test",
                       "--batch_size", "32", "--device", "cpu",
                       "--valid_ratio", "0", "--model_save_root", root,
                       *extra])
    state = result["state"]
    sharded = sorted(n for n, p in state.model.named_parameters()
                     if getattr(p, "row_shard", None) is not None)
    final = os.path.join(root, "ckpt", "final.pt")
    shape = tuple(torch.load(final, weights_only=True)["model"][
        "embedder.table_dim16"].shape) if os.path.isfile(final) else None
    return state.step, sharded, result["history"][-1], shape


def expert_steps(rank, world, path, kw, tree, batches, conf_path):
    """Mmoe with shard_experts on a ('dp', 'ep') mesh of (world / 2, 2):
    three steps of this rank's dp rows from a carried tree -> (losses, the
    whole state tree, the replicas' digests, the expert blocks' shapes)."""
    import ml_dtypes
    from recommendflow_tpu_torch import interop
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.parallel.mesh import shard_batch
    from recommendflow_tpu_torch.train.trainer import Trainer
    mesh = make_mesh(("dp", "ep"), (world // 2, 2))
    conf = Configuration(conf_path)
    model, _ = build_network(path, {"conf": conf, "device": "cpu", **kw})
    t = Trainer(model, learning_rate=1e-3, table_update="split",
                split_strategy="sparse_set", device="cpu", mesh=mesh,
                shard_experts=True)
    local = [shard_batch(mesh, b) for b in batches]
    state = t.init_state(local[0])
    interop.load_train_state(state, tree)
    losses = []
    for b in local[1:]:
        state, m = t.train_step(state, b)
        losses.append(float(m["loss"]))
    blocks = {n: tuple(p.shape) for n, p in t.model.named_parameters()
              if getattr(p, "row_shard", None) is not None}
    return (losses, interop.flatten(interop.train_state_tree(
        state, ml_dtypes.bfloat16)), replica_digests(state), blocks)


def dp_predict(rank, world, batches, shard):
    """predict and evaluate on this rank's rows of each global batch, from
    the seeded weights (the same on every rank)."""
    from recommendflow_tpu_torch.parallel.mesh import shard_batch
    t = dp_trainer({"tower_units": [32]}, "sparse", "auto", shard)
    local = [shard_batch(t.mesh, b) for b in batches]
    state = t.init_state(local[0])
    return t.predict(state, local), t.evaluate(state, local)


# --------------------------------- a chosen optimizer and dice on a mesh
def _whole_state(state):
    """The model's whole weights and buffers (row blocks gathered) as a
    flax variable tree of numpy arrays, and the optimizer's whole state
    (state_to_host's)."""
    import ml_dtypes
    from recommendflow_tpu_torch import interop
    from recommendflow_tpu_torch.train.checkpoint import state_to_host
    host = state_to_host(state)
    return (interop.jax_from_variables(host["model"], ml_dtypes.bfloat16),
            {n: {k: _np(v) for k, v in st.items()}
             for n, st in host["optimizer"]["state"].items()})


def mesh_model_trainer(path, kw, conf_path, networks, variables, opt,
                       mesh=None, shard_tables=False, shard_experts=False):
    """A model built from `path` on `conf_path` (Networks overrides
    `networks`), carrying the flax `variables`, under a Trainer with the
    chosen optimizer `opt` ({"partitioned": bool, **make_*_optimizer
    kwargs}, or None for the default) on `mesh`."""
    from recommendflow_tpu_torch import interop
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.optimizers import (
        make_optimizer, make_partitioned_optimizer)
    from recommendflow_tpu_torch.train.trainer import Trainer
    conf = Configuration(conf_path)
    conf.networks.update(networks)
    model, _ = build_network(path, {"conf": conf, "device": "cpu", **kw})
    interop.load_jax_variables(model, variables)
    spec = None
    if opt is not None:
        opt = dict(opt)
        make = make_partitioned_optimizer if opt.pop("partitioned", False) \
            else make_optimizer
        spec = make(**opt)
    extra = {} if spec is None else {"optimizer": spec}
    return Trainer(model, learning_rate=1e-3, table_update="split",
                   split_strategy="sparse_set", device="cpu", seed=0,
                   mesh=mesh, shard_tables=shard_tables,
                   shard_experts=shard_experts, **extra)


def mesh_model_steps(rank, world, path, kw, conf_path, networks, variables,
                     opt, batches, axes, shape, shard_tables=False,
                     shard_experts=False):
    """Steps of this rank's dp rows of each global batch from the carried
    flax variables on a mesh of `axes` x `shape`: (losses, the whole
    variables after the steps, the row blocks' shapes, the replicas'
    digests)."""
    from recommendflow_tpu_torch.parallel.mesh import shard_batch
    mesh = make_mesh(axes, shape)
    t = mesh_model_trainer(path, kw, conf_path, networks, variables, opt,
                           mesh, shard_tables, shard_experts)
    local = [shard_batch(mesh, b) for b in batches]
    state = t.init_state(local[0])
    losses = []
    for b in local:
        state, m = t.train_step(state, b)
        losses.append(float(m["loss"]))
    blocks = {n: tuple(p.shape) for n, p in t.model.named_parameters()
              if getattr(p, "row_shard", None) is not None}
    digests = {n: _digest(p) for n, p in t.model.named_parameters()
               if getattr(p, "row_shard", None) is None}
    return losses, _whole_state(state)[0], blocks, digests


def mesh_model_ckpt(rank, world, path, kw, conf_path, networks, variables,
                    opt, batches, axes, shape, shard_tables, shard_experts,
                    file, steps_before, mode):
    """mode 'save': `steps_before` steps of the global batches, save to
    `file`, then the rest; mode 'resume': restore `file` into a fresh
    trainer and take the rest. Returns (the whole optimizer state right
    after the save or the restore, the whole variables and optimizer state
    at the end, the step)."""
    from recommendflow_tpu_torch.parallel.mesh import shard_batch
    from recommendflow_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                          save_checkpoint)
    mesh = make_mesh(axes, shape)
    t = mesh_model_trainer(path, kw, conf_path, networks, variables, opt,
                           mesh, shard_tables, shard_experts)
    local = [shard_batch(mesh, b) for b in batches]
    state = t.init_state(local[0])
    if mode == "save":
        for b in local[:steps_before]:
            state, _ = t.train_step(state, b)
        save_checkpoint(file, state)
    else:
        restore_checkpoint(file, state)
    at = _whole_state(state)[1]
    for b in local[steps_before:]:
        state, _ = t.train_step(state, b)
    return at, _whole_state(state), state.step
