"""Carry weights between the JAX package's flax variable trees and the port.

The flax tree (as host numpy) maps onto a model's state dict one to one:

  params/embedder/table_dim{d}          -> embedder.table_dim{d}  (stored layout, as is)
  params/<m>/Dense_i/kernel [in, out]   -> <m>.Dense_i.weight [out, in]
  params/<m>/Dense_i/bias               -> <m>.Dense_i.bias
  params/<m>/BatchNorm_i/{scale, bias}  -> <m>.BatchNorm_i.{weight, bias}
  batch_stats/<m>/BatchNorm_i/{mean, var}
                                        -> <m>.BatchNorm_i.{running_mean, running_var}

Every `kernel` leaf is a Dense layer's, whatever its owner is called
(`Dense_i`, or a role: `head`, `gate{t}`, `linear`, `q`, ...): a 2-D kernel
becomes a transposed `weight`, and Mmoe's stacked [E, in, out] expert
kernels (flax `nn.vmap`) a `weight` of the same layout. Bare parameters
(`w{i}`, `b{i}`, `field_latents`, `pos_emb`, Dice's `alpha`,
LocationBasedAttention's `query` [D, 1]) keep their names and layouts. A
BatchNorm without scale or bias (Dice's `BatchNorm_0`) has only its
`batch_stats`, and the port's module only its running statistics.
For the text encoder (`ops/transformer.py:TextEncoder`), LayerNorm and
Embed modules:

  params/.../mha/{q,k,v,out}/kernel     -> ....mha.{q,k,v,out}.weight (transposed)
  params/.../{emb_ln,ln1,ln2}/{scale, bias}
                                        -> ....{emb_ln,ln1,ln2}.{weight, bias}
  params/{tok_emb,seg_emb}/embedding    -> {tok_emb,seg_emb}.weight (Esim's
                                           tok_emb too)
  params/pos_emb                        -> pos_emb (a bare parameter, as is)

AttentionFusion's `stats` collection (ops/fusion.py) and the logQ
correction's `freq` collection (models/base.py:FreqEstimator) map onto
their buffers,
and an image slot's patch projection and ViT (models/base.py) onto the
embedder's parameter and submodule of the same names:

  stats/<m>/{infer_weights, infer_count} -> <m>.{infer_weights, infer_count}
  freq/state/{last_step, interval}      -> freq.{last_step, interval}
  freq/step                             -> freq.step
  params/embedder/img_proj_<name>       -> embedder.img_proj_<name> (as is)
  params/embedder/vit_<name>/{patch_proj, cls, pos_emb, emb_ln, block{i}, head}
                                        -> embedder.vit_<name>.…

bf16 leaves arrive as `ml_dtypes.bfloat16` arrays, or as 2-byte void arrays
when read back from an .npz without ml_dtypes installed; both move through a
uint16 view, never through float32, so the bits are kept.

The weights file the port's CLIs read besides their own checkpoints
(train/checkpoint.py) is an .npz of the flattened tree with '/'-joined keys:
what `np.savez(path, **flax.traverse_util.flatten_dict(variables, sep="/"))`
writes from the JAX side.

A training state crosses as a plain tree of numpy arrays (what the JAX side
reads off its TrainState: `params`, `batch_stats`, the split or sparse
path's `table_acc` and the optax row-wise Adagrad accumulators of the
tables on the dense path, and the dense leaves' Adam moments):

  {"params": ..., "batch_stats": ..., "stats" and "freq": ... (where the
   model has them),
   "table_acc": {"dim{d}": [R/P, 1] f32},
   "opt": {"mu": params tree of the dense leaves, "nu": likewise,
           "count": int},
   "step": int}

`load_train_state` copies it into a port TrainState (train/trainer.py),
`train_state_tree` reads one back out.

A row-sharded table or expert block (parallel/sharded_embedding.py)
crosses whole: loading copies this rank's block of the tree's leaf (and of
its accumulator or Adam moments) into the rank's shard, so every package
and world size starts from the same weights, and `train_state_tree`
gathers the blocks back into whole arrays (a collective every rank
calls).

An Mmoe tree written before the JAX package batched its experts (one
`expert{i}` subtree per expert) is brought to the stacked layout by
`models/ranking/mmoe.py:migrate_legacy_params` as it is loaded.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from recommendflow_tpu_torch.parallel.sharded_embedding import (
    full_rows, gather_like, own_rows)
from recommendflow_tpu_torch.train.checkpoint import (_acc_tables,
                                                      assign_param_state)

Tree = Dict[str, Any]

_DENSE = {"kernel": "weight", "bias": "bias"}
_LAYER_NORM = {"scale": "weight", "bias": "bias"}
_EMBED = {"embedding": "weight"}
_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS = ("infer_weights", "infer_count")   # AttentionFusion's statistics
_FREQ_STATE = ("last_step", "interval")     # FreqEstimator's per-bucket state
COLLECTIONS = ("params", "batch_stats", "stats", "freq")


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                            and arr.dtype.itemsize == 2)


def to_tensor(arr) -> torch.Tensor:
    """numpy (incl. bf16) -> CPU tensor with the same bits."""
    arr = np.asarray(arr)
    if _is_bf16(arr):
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """CPU copy as numpy; a bf16 tensor becomes `bf16_dtype` (e.g.
    ml_dtypes.bfloat16) or, when None, a 2-byte void array of the same bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16).copy()
        return bits.view(bf16_dtype if bf16_dtype is not None else np.dtype("V2"))
    return t.numpy().copy()


def flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def unflatten(flat: Mapping[Tuple[str, ...], Any]) -> Tree:
    tree: Tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _leaf_names(owner: str) -> Dict[str, str]:
    """flax leaf name -> torch name in the params of a module named `owner`
    (BatchNorm aside): LayerNorm and Embed modules by name, a Dense layer
    (a `kernel` leaf) under any other."""
    if owner.startswith("LayerNorm") or owner in ("emb_ln", "ln1", "ln2"):
        return _LAYER_NORM
    if owner.startswith("Embed") or owner in ("tok_emb", "seg_emb"):
        return _EMBED
    return _DENSE


def _torch_key(path: Tuple[str, ...]) -> str:
    collection, *mods, leaf = path
    owner = mods[-1] if mods else ""
    if collection == "freq":
        return f"freq.{leaf}"
    if owner.startswith("BatchNorm"):
        leaf = (_BN_PARAMS if collection == "params" else _BN_STATS)[leaf]
    elif collection == "stats" and leaf in _STATS:
        pass
    elif collection != "params":
        raise KeyError(f"no state-dict counterpart for {'/'.join(path)}")
    else:
        leaf = _leaf_names(owner).get(leaf, leaf)
    return ".".join(mods + [leaf])


def variables_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variable tree {'params': ..., 'batch_stats': ...} as numpy ->
    state dict of CPU tensors."""
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in flatten(variables).items():
        t = to_tensor(leaf)
        if path[0] == "params" and path[-1] == "kernel" and t.dim() == 2:
            t = t.T.contiguous()
        state[_torch_key(path)] = t
    return state


def jax_from_variables(state: Mapping[str, torch.Tensor],
                       bf16_dtype=None) -> Tree:
    """The reverse of variables_from_jax: state dict -> flax variable tree
    of numpy arrays. `bf16_dtype` as in to_numpy."""
    flat: Dict[Tuple[str, ...], np.ndarray] = {}
    inv_bn = {v: ("params", k) for k, v in _BN_PARAMS.items()}
    inv_bn.update({v: ("batch_stats", k) for k, v in _BN_STATS.items()})
    for key, t in state.items():
        *mods, leaf = key.split(".")
        owner = mods[-1] if mods else ""
        arr = to_numpy(t, bf16_dtype)
        if mods == ["freq"]:
            flat[("freq", "state", leaf) if leaf in _FREQ_STATE
                 else ("freq", leaf)] = arr
            continue
        if owner.startswith("BatchNorm"):
            collection, name = inv_bn[leaf]
            flat[(collection, *mods, name)] = arr
            continue
        if leaf in _STATS:
            flat[("stats", *mods, leaf)] = arr
            continue
        name = {v: k for k, v in _leaf_names(owner).items()}.get(leaf, leaf)
        if name == "kernel" and arr.ndim == 2:
            arr = np.ascontiguousarray(arr.T)
        flat[("params", *mods, name)] = arr
    return unflatten(flat)


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]
                       ) -> torch.nn.Module:
    """Copy a flax variable tree into `model` in place (onto its device).
    Every parameter and buffer must be covered. A model with a
    `migrate_legacy_params` (Mmoe) first brings an older params layout to
    its own."""
    migrate = getattr(model, "migrate_legacy_params", None)
    if migrate is not None and "params" in variables:
        variables = {**variables, "params": migrate(variables["params"])}
    params = dict(model.named_parameters())
    state = {k: own_rows(params[k], t) if k in params else t
             for k, t in variables_from_jax(variables).items()}
    own = model.state_dict()
    missing = [k for k in own if k not in state]
    unexpected = [k for k in state if k not in own]
    if missing or unexpected:
        raise KeyError(f"variable tree does not match the model: missing "
                       f"{missing}, unexpected {unexpected}")
    for k, t in state.items():
        if tuple(own[k].shape) != tuple(t.shape) or own[k].dtype != t.dtype:
            raise ValueError(f"{k}: got {t.dtype} {tuple(t.shape)}, model has "
                             f"{own[k].dtype} {tuple(own[k].shape)}")
    with torch.no_grad():
        for k, t in state.items():
            own[k].copy_(t)
    return model


def save_variables_npz(path: str, variables: Mapping[str, Any]) -> str:
    """Write a variable tree as an .npz of '/'-joined keys (bf16 leaves as
    2-byte void arrays of their bits). Returns the path written."""
    flat = {"/".join(p): np.asarray(v) for p, v in flatten(variables).items()}
    flat = {k: (v.view(np.dtype("V2")) if _is_bf16(v) else v)
            for k, v in flat.items()}
    out = path if path.endswith(".npz") else path + ".npz"
    np.savez(out, **flat)
    return out


def load_variables_npz(path: str) -> Tree:
    """Read an .npz of a flattened flax variable tree back into a tree."""
    with np.load(path, allow_pickle=False) as data:
        return unflatten({tuple(k.split("/")): data[k] for k in data.files})


def _dense_params(state) -> Dict[str, torch.nn.Parameter]:
    """name -> parameter for every parameter the optimizer updates. The tree
    carries the default optimizer's Adam moments only (a user-chosen
    `OptaxOptimizer` keeps another state: TypeError)."""
    if not isinstance(state.optimizer, torch.optim.Adam):
        raise TypeError(f"the training-state tree carries torch.optim.Adam's "
                        f"moments, not {type(state.optimizer).__name__}'s")
    mine = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    return {n: p for n, p in state.model.named_parameters() if id(p) in mine}


def load_train_state(state, tree: Mapping[str, Any]):
    """Copy a training-state tree (module docstring) into a port TrainState,
    in place, onto its devices. Returns state."""
    load_jax_variables(state.model, {k: tree[k] for k in COLLECTIONS
                                     if k in tree})
    accs = tree.get("table_acc") or {}
    if sorted(accs) != sorted(state.table_acc):
        raise KeyError(f"table_acc {sorted(accs)} does not match the state's "
                       f"{sorted(state.table_acc)}")
    tables = _acc_tables(state.model)
    with torch.no_grad():
        for k, v in accs.items():
            state.table_acc[k].copy_(own_rows(tables[k], to_tensor(v))
                                     if k in tables else to_tensor(v))
    opt = tree["opt"]
    mu = variables_from_jax({"params": opt["mu"]})
    nu = variables_from_jax({"params": opt["nu"]})
    dense = _dense_params(state)
    if sorted(mu) != sorted(dense) or sorted(nu) != sorted(dense):
        raise KeyError(f"Adam moments {sorted(mu)} do not match the dense "
                       f"parameters {sorted(dense)}")
    group = {id(p): g for g in state.optimizer.param_groups
             for p in g["params"]}
    for name, p in dense.items():
        assign_param_state(state.optimizer, group[id(p)], p, {
            "step": torch.tensor(float(opt["count"])),
            "exp_avg": own_rows(p, mu[name]),
            "exp_avg_sq": own_rows(p, nu[name])})
    state.step = int(tree["step"])
    return state


def train_state_tree(state, bf16_dtype=None) -> Tree:
    """A port TrainState as a training-state tree of numpy arrays (module
    docstring); `bf16_dtype` as in to_numpy."""
    params = dict(state.model.named_parameters())
    tree = jax_from_variables({k: full_rows(params[k]) if k in params else t
                               for k, t in state.model.state_dict().items()},
                              bf16_dtype)
    tables = _acc_tables(state.model)
    tree["table_acc"] = {k: to_numpy(gather_like(tables.get(k), v))
                         for k, v in state.table_acc.items()}
    dense = _dense_params(state)
    moments, count = {"exp_avg": {}, "exp_avg_sq": {}}, 0
    for name, p in dense.items():
        st = state.optimizer.state.get(p, {})
        count = int(st["step"]) if "step" in st else 0
        for key in moments:
            moments[key][name] = gather_like(p, st.get(key,
                                                       torch.zeros_like(p)))
    tree["opt"] = {"mu": jax_from_variables(moments["exp_avg"])["params"],
                   "nu": jax_from_variables(moments["exp_avg_sq"])["params"],
                   "count": count}
    tree["step"] = int(state.step)
    return tree
