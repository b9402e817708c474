"""Carry weights between the JAX package's flax variable trees and the port.

The flax tree (as host numpy) maps onto a model's state dict one to one:

  params/embedder/table_dim{d}          -> embedder.table_dim{d}  (stored layout, as is)
  params/<m>/Dense_i/kernel [in, out]   -> <m>.Dense_i.weight [out, in]
  params/<m>/Dense_i/bias               -> <m>.Dense_i.bias
  params/<m>/BatchNorm_i/{scale, bias}  -> <m>.BatchNorm_i.{weight, bias}
  batch_stats/<m>/BatchNorm_i/{mean, var}
                                        -> <m>.BatchNorm_i.{running_mean, running_var}

bf16 leaves arrive as `ml_dtypes.bfloat16` arrays, or as 2-byte void arrays
when read back from an .npz without ml_dtypes installed; both move through a
uint16 view, never through float32, so the bits are kept.

The checkpoint file of the port's CLIs is an .npz of the flattened tree with
'/'-joined keys: what `np.savez(path, **flax.traverse_util.flatten_dict(
variables, sep="/"))` writes from the JAX side.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]

_DENSE = {"kernel": "weight", "bias": "bias"}
_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


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
        bits = t.view(torch.int16).numpy().view(np.uint16)
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


def _torch_key(path: Tuple[str, ...]) -> str:
    collection, *mods, leaf = path
    owner = mods[-1] if mods else ""
    if owner.startswith("Dense") and collection == "params":
        leaf = _DENSE[leaf]
    elif owner.startswith("BatchNorm"):
        leaf = (_BN_PARAMS if collection == "params" else _BN_STATS)[leaf]
    elif collection != "params":
        raise KeyError(f"no state-dict counterpart for {'/'.join(path)}")
    return ".".join(mods + [leaf])


def variables_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variable tree {'params': ..., 'batch_stats': ...} as numpy ->
    state dict of CPU tensors (no num_batches_tracked: see load_jax_variables)."""
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
    inv_dense = {v: k for k, v in _DENSE.items()}
    inv_bn = {v: ("params", k) for k, v in _BN_PARAMS.items()}
    inv_bn.update({v: ("batch_stats", k) for k, v in _BN_STATS.items()})
    for key, t in state.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        owner = mods[-1] if mods else ""
        arr = to_numpy(t, bf16_dtype)
        if owner.startswith("Dense"):
            name = inv_dense[leaf]
            if name == "kernel":
                arr = np.ascontiguousarray(arr.T)
            flat[("params", *mods, name)] = arr
        elif owner.startswith("BatchNorm"):
            collection, name = inv_bn[leaf]
            flat[(collection, *mods, name)] = arr
        else:
            flat[("params", *mods, leaf)] = arr
    return unflatten(flat)


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]
                       ) -> torch.nn.Module:
    """Copy a flax variable tree into `model` in place (onto its device).
    Every parameter and buffer must be covered, except BatchNorm's
    num_batches_tracked counter, which flax does not keep."""
    state = variables_from_jax(variables)
    own = model.state_dict()
    missing = [k for k in own if k not in state
               and not k.endswith("num_batches_tracked")]
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
