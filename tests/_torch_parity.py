"""Shared helpers for the recommendflow_tpu_torch parity tests.

Both packages run in one CPU process: JAX is pinned to the CPU by
conftest.py, torch to one thread here (the tier-1 run uses several xdist
workers). Inputs are built with numpy from a seed and handed to both sides.
"""
import os
import signal

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DEMO_CONF = os.path.join(ROOT, "conf", "demo_recall.yaml")
BENCH_CONF = os.path.join(ROOT, "conf", "bench_recall.yaml")


def conf_pair(path=DEMO_CONF, networks=None):
    """The same YAML loaded by both packages, with optional Networks
    overrides applied to both."""
    from recommendflow_tpu.config import Configuration as JConf
    from recommendflow_tpu_torch.config import Configuration as TConf
    jc, tc = JConf(path), TConf(path)
    for k, v in (networks or {}).items():
        jc.networks[k] = v
        tc.networks[k] = v
    return jc, tc


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def to_jax(batch):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch.items()}


def bf16_bits(x) -> np.ndarray:
    """uint16 bit pattern of a bf16 array from either side."""
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _states(tree, cls):
    import jax
    return [x for x in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, cls)) if isinstance(x, cls)]


def _nested(tree):
    """A pytree of arrays (masked leaves dropped) -> nested dict of numpy."""
    import jax
    from recommendflow_tpu_torch.interop import unflatten
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return unflatten({tuple(str(getattr(k, "key", k)) for k in path):
                      np.asarray(leaf) for path, leaf in flat})


def jax_state_tree(state):
    """A JAX TrainState of the default partitioned optimizer as the port's
    training-state tree (recommendflow_tpu_torch/interop.py): params,
    batch_stats, the logQ 'freq' collection where the model has it, the
    tables' row-wise Adagrad accumulators (the split or sparse path's
    table_acc, and the optax accumulators of the tables on the dense path),
    the dense leaves' Adam moments and count, and the step."""
    import optax
    from recommendflow_tpu.train.optimizers import RowwiseAdagradState
    (adam,) = _states(state.opt_state, optax.ScaleByAdamState)
    accs = {k: np.asarray(v) for k, v in (state.table_acc or {}).items()}
    for ada in _states(state.opt_state, RowwiseAdagradState):
        flat = {p[-1]: v for p, v in _flat(_nested(ada.accumulator)).items()}
        accs.update({k.replace("table_", ""): v for k, v in flat.items()
                     if k.startswith("table_dim")})
    extra = {k: _nested(v) for k, v in (state.extra_vars or {}).items()
             if k == "freq"}
    return {"params": _nested(state.params),
            "batch_stats": _nested(state.batch_stats), **extra,
            "table_acc": accs,
            "opt": {"mu": _nested(adam.mu), "nu": _nested(adam.nu),
                    "count": int(adam.count)},
            "step": int(state.step)}


def _flat(tree):
    from recommendflow_tpu_torch.interop import flatten
    return flatten(tree)


def flat_tree(tree):
    """Training-state tree -> {'/'-joined path: numpy or int}."""
    return {"/".join(k): v for k, v in _flat(tree).items()}


def bf16_ulp_err(a, b) -> float:
    """Largest |a - b| in units of the bf16 spacing at max(|a|, |b|) (a
    difference of one rounding is <= 1 however close to zero the values
    are)."""
    a32, b32 = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.maximum(np.abs(a32), np.abs(b32)), np.float32(2.0 ** -126))
    spacing = np.exp2(np.floor(np.log2(mag)) - 7)
    return float((np.abs(a32 - b32) / spacing).max()) if a32.size else 0.0


def clustered_world():
    """A clustered corpus (IVF's regime): 24 latent clusters in 32 dims,
    scaled so that ip scores stay near 10 (f32 spacing ~1e-6)."""
    rng = np.random.RandomState(11)
    centers = rng.randn(24, 32).astype(np.float32) * 0.5
    corpus = (centers[rng.randint(24, size=4000)] +
              rng.randn(4000, 32).astype(np.float32) * 0.125)
    queries = corpus[:40] + rng.randn(40, 32).astype(np.float32) * 0.04
    return corpus, queries


def agree(a, b, atol, score_of=None):
    """(scores, ids) pairs: scores within atol; ids equal except where the
    two ids' scores (score_of(row, id), else the returned ones) tie within
    atol."""
    (sa, ia), (sb, ib) = a, b
    assert sa.shape == sb.shape and ia.shape == ib.shape
    np.testing.assert_allclose(sa, sb, rtol=0, atol=atol)
    for r, c in zip(*np.nonzero(ia != ib)):
        if score_of is not None:
            assert abs(score_of(r, ia[r, c]) - score_of(r, ib[r, c])) <= atol
        else:
            assert abs(sa[r, c] - sb[r, c]) <= atol


def demo_batches(n: int, seed: int, batch: int = 64) -> "Batches":
    """n synthetic demo_recall batches (the port's synthetic_batch, seeds
    seed, seed + 1, ...) as a Batches dataset."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.data.schema import compile_schema
    from recommendflow_tpu_torch.data.synthetic import synthetic_batch
    schema = compile_schema(Configuration(DEMO_CONF).features)
    return Batches([synthetic_batch(schema, batch, seed=seed + i)
                    for i in range(n)])


def demo_trainer(networks, dropout=0.3, seed=9, device="cpu", **kw):
    """A port Trainer on `device` over a demo_recall Dssm (Networks
    overrides `networks`, weights from seed 0), split "sparse_set" unless
    `kw` says otherwise."""
    from recommendflow_tpu_torch.config import Configuration
    from recommendflow_tpu_torch.models.base import build_network
    from recommendflow_tpu_torch.train.trainer import Trainer
    conf = Configuration(DEMO_CONF)
    conf.networks.update(networks)
    model, _ = build_network(conf.networks["class"],
                             {"conf": conf, "dropout": dropout,
                              "device": device, "seed": 0})
    kw.setdefault("split_strategy", "sparse_set")
    return Trainer(model, learning_rate=1e-3, device=device, seed=seed, **kw)


class Batches:
    """Fixed batches with a length and `iter_from(skip, epoch)` (odd epochs
    run in reverse), as the record Dataset resumes."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, skip=0, epoch=0):
        order = self.batches[::-1] if epoch % 2 else self.batches
        return iter(order[skip:])


class KillAt:
    """A dataset that sends this process SIGTERM as it yields its n-th batch
    (counted from the start of each iteration; prefetch's thread draws it,
    the handler runs in the main thread)."""

    def __init__(self, inner, n):
        self.inner, self.n = inner, n

    def __len__(self):
        return len(self.inner)

    def _kill(self, it):
        for i, b in enumerate(it):
            if i == self.n:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    def __iter__(self):
        return self._kill(iter(self.inner))

    def iter_from(self, skip=0, epoch=0):
        return self._kill(self.inner.iter_from(skip, epoch))
