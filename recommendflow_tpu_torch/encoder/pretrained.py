"""Pretrained BERT checkpoint import into the port's `TextEncoder`, and its
graft into a model's encoders (the counterpart of
`recommendflow_tpu/encoder/pretrained.py`).

The checkpoint is read into one canonical name space
('embeddings/word_embeddings', 'encoder/layer_0/attention/self/query/kernel',
in flax's [in, out] layout), mapped onto the flax `TextEncoder` params tree
that the JAX package builds, and copied into the module through
`interop.load_jax_variables`. So both packages load the same checkpoint into
the same numbers.

Formats: the HuggingFace torch state dict (`pytorch_model.bin`, `.pt`,
`.pth`; `.safetensors` when the `safetensors` package is installed) and the
Google-TF checkpoint, which needs `tensorflow` and raises ImportError where
it is not installed.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["bert_encoder_kwargs", "load_bert_checkpoint", "bert_params_to_flax",
           "load_pretrained_text_encoder", "graft_params", "apply_pretrained"]

# HF hidden_act -> the activation table's names (ops/mlp.py): "gelu" is the
# erf gelu of HF BERT and bert4keras; "gelu_new" the tanh form
_ACT_MAP = {"gelu": "gelu_exact", "gelu_new": "gelu", "gelu_python":
            "gelu_exact", "relu": "relu", "silu": "silu", "swish": "silu"}


def bert_encoder_kwargs(config_path: str, max_len: Optional[int] = None,
                        **overrides) -> Dict[str, Any]:
    """bert_config.json -> TextEncoder constructor kwargs. `max_len` clips
    the positional table; overrides win last."""
    with open(config_path) as f:
        cfg = json.load(f)
    pos_max = int(cfg.get("max_position_embeddings", 512))
    kwargs: Dict[str, Any] = dict(
        vocab_size=int(cfg["vocab_size"]),
        num_layers=int(cfg.get("num_hidden_layers", 12)),
        model_dim=int(cfg.get("hidden_size", 768)),
        num_heads=int(cfg.get("num_attention_heads", 12)),
        ffn_hidden=int(cfg.get("intermediate_size", 4 * cfg.get("hidden_size", 768))),
        max_len=min(pos_max, max_len) if max_len else pos_max,
        dropout=float(cfg.get("hidden_dropout_prob", 0.1)),
        type_vocab_size=int(cfg.get("type_vocab_size", 2)),
        pos_type="learned",
        ln_epsilon=float(cfg.get("layer_norm_eps", 1e-12)),
        ffn_activation=_ACT_MAP.get(str(cfg.get("hidden_act", "gelu")), "gelu_exact"),
    )
    kwargs.update(overrides)
    return kwargs


# ----------------------------------------------------------------- readers
def _canon(name: str) -> str:
    """A TF-variable or torch-state-dict name in canonical form:
    'embeddings/word_embeddings', 'encoder/layer_0/attention/self/query/kernel'.
    """
    n = name.replace(".", "/")
    n = re.sub(r"^(bert|electra|roberta)/", "", n)
    n = re.sub(r"/layer/(\d+)/", r"/layer_\1/", n)   # torch 'layer.0.'
    n = n.replace("/gamma", "/scale").replace("/beta", "/bias")
    return n


def _read_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            f"'{path}' is a TF checkpoint, which needs tensorflow to read; "
            "convert it to a torch state dict (pytorch_model.bin) where "
            "tensorflow is not installed") from e
    reader = tf.train.load_checkpoint(path)
    out = {}
    for name in reader.get_variable_to_shape_map():
        if "adam" in name.lower() or "global_step" in name or "optimizer" in name:
            continue  # training slots in released checkpoints
        key = _canon(name)
        arr = np.asarray(reader.get_tensor(name))
        # TF dense kernels are [in, out], the flax layout
        if key.endswith("/kernel") or "embeddings" in key or key.endswith(("/scale", "/bias")):
            out[key] = arr
    return out


def _read_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        items = load_file(path).items()
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(raw, dict) and "state_dict" in raw:
            raw = raw["state_dict"]
        items = ((k, v.detach().numpy()) for k, v in raw.items())
    out = {}
    for name, arr in items:
        key = _canon(name)
        arr = np.asarray(arr)
        if key.endswith("/weight"):
            if arr.ndim == 2 and "embeddings" not in key:
                # torch Linear weight [out, in] -> flax kernel [in, out]
                out[key[:-len("/weight")] + "/kernel"] = arr.T
            elif arr.ndim == 1:  # LayerNorm weight
                out[key[:-len("/weight")] + "/scale"] = arr
            else:                # embedding tables
                out[key[:-len("/weight")]] = arr
        else:
            out[key] = arr       # '/bias' and friends pass through
    return out


def load_bert_checkpoint(checkpoint_path: str) -> Dict[str, np.ndarray]:
    """Read a BERT checkpoint into {canonical name: np.ndarray}: a torch
    state-dict file (`pytorch_model.bin` / `model.safetensors`) or a
    Google-TF checkpoint prefix (`.../bert_model.ckpt`)."""
    if checkpoint_path.endswith((".bin", ".pt", ".pth", ".safetensors")):
        return _read_torch_state_dict(checkpoint_path)
    if (os.path.exists(checkpoint_path + ".index")
            or os.path.isdir(checkpoint_path)
            or ".ckpt" in os.path.basename(checkpoint_path)):
        return _read_tf_checkpoint(checkpoint_path)
    raise FileNotFoundError(
        f"cannot identify checkpoint format at '{checkpoint_path}' — expected "
        "a TF checkpoint prefix (with .index alongside) or a torch "
        ".bin/.pt/.safetensors file")


# --------------------------------------------------------------- converter
def _take(weights: Dict[str, np.ndarray], key: str) -> np.ndarray:
    if key not in weights:
        raise KeyError(
            f"pretrained checkpoint is missing '{key}' — have "
            f"{sorted(k for k in weights if '/layer_' not in k)} (+ layer vars)")
    return weights[key]


def bert_params_to_flax(weights: Dict[str, np.ndarray], *, num_layers: int,
                        max_len: int, num_heads: int) -> Dict[str, Any]:
    """Canonical BERT weights -> the flax TextEncoder 'params' tree (with
    pos_type='learned'): tok_emb/seg_emb embeddings, the pos_emb table,
    emb_ln, then per block mha.{q,k,v,out} + ln1 + ffn.{Dense_0,Dense_1} +
    ln2."""
    e = "embeddings/"
    params: Dict[str, Any] = {
        "tok_emb": {"embedding": _take(weights, e + "word_embeddings")},
        "seg_emb": {"embedding": _take(weights, e + "token_type_embeddings")},
        "pos_emb": _take(weights, e + "position_embeddings")[:max_len],
        "emb_ln": {"scale": _take(weights, e + "LayerNorm/scale"),
                   "bias": _take(weights, e + "LayerNorm/bias")},
    }
    dim = params["tok_emb"]["embedding"].shape[1]
    if dim % num_heads:
        raise ValueError(f"hidden size {dim} not divisible by {num_heads} heads")
    for i in range(num_layers):
        L = f"encoder/layer_{i}/"

        def dense(sub):
            return {"kernel": _take(weights, L + sub + "/kernel"),
                    "bias": _take(weights, L + sub + "/bias")}

        def ln(sub):
            return {"scale": _take(weights, L + sub + "/scale"),
                    "bias": _take(weights, L + sub + "/bias")}

        params[f"block{i}"] = {
            "mha": {"q": dense("attention/self/query"),
                    "k": dense("attention/self/key"),
                    "v": dense("attention/self/value"),
                    "out": dense("attention/output/dense")},
            "ln1": ln("attention/output/LayerNorm"),
            "ffn": {"Dense_0": dense("intermediate/dense"),
                    "Dense_1": dense("output/dense")},
            "ln2": ln("output/LayerNorm"),
        }
    return params


def load_pretrained_text_encoder(config_path: str, checkpoint_path: str,
                                 max_len: Optional[int] = None, device="cuda",
                                 **encoder_overrides) -> Tuple[Any, Dict[str, Any]]:
    """(config json, checkpoint) -> (TextEncoder on `device` holding the
    checkpoint's weights, the flax variables {'params': ...} as numpy).
    `encoder_overrides` set pooling/out_layer/pool_pos etc. without
    affecting weight loading."""
    from recommendflow_tpu_torch.interop import load_jax_variables
    from recommendflow_tpu_torch.ops.transformer import TextEncoder
    kwargs = bert_encoder_kwargs(config_path, max_len=max_len,
                                 **encoder_overrides)
    weights = load_bert_checkpoint(checkpoint_path)
    variables = {"params": bert_params_to_flax(
        weights, num_layers=kwargs["num_layers"], max_len=kwargs["max_len"],
        num_heads=kwargs["num_heads"])}
    model = TextEncoder(**kwargs, device=device)
    load_jax_variables(model, variables)
    return model, variables


# ------------------------------------------------------------ model grafts
def graft_params(model: torch.nn.Module, module_name: str,
                 sub_params: Dict[str, Any]) -> torch.nn.Module:
    """Copy the flax params tree `sub_params` into every submodule of
    `model` named `module_name` (at any depth), through interop, each leaf
    cast to the dtype the model holds. Raises KeyError when no submodule
    has that name, ValueError naming the module when its leaves and the
    tree's differ in names or shapes (a partial copy would train garbage);
    nothing is copied then. Returns model."""
    from recommendflow_tpu_torch.interop import variables_from_jax
    targets = [(path, m) for path, m in model.named_modules()
               if path.rsplit(".", 1)[-1] == module_name]
    if not targets:
        raise KeyError(f"no module named '{module_name}' in the model")
    state = variables_from_jax({"params": sub_params})
    for path, module in targets:
        _check_shapes(module.state_dict(), state, "/" + path.replace(".", "/"))
    with torch.no_grad():
        for _, module in targets:
            own = module.state_dict()
            for k, t in state.items():
                own[k].copy_(t.to(own[k].dtype))
    return model


def _check_shapes(old: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                  where: str) -> None:
    old_shapes = {k: tuple(v.shape) for k, v in old.items()}
    new_shapes = {k: tuple(v.shape) for k, v in new.items()}
    if old_shapes != new_shapes:
        raise ValueError(
            f"pretrained params do not match module '{where}': model has "
            f"{old_shapes}, checkpoint gives {new_shapes} — configure the "
            "model from the same bert_config.json (bert_encoder_kwargs)")


def apply_pretrained(model: torch.nn.Module) -> torch.nn.Module:
    """Graft every pretrained encoder named under `Networks.pretrained` into
    `model` (the trainer's init hook):

        Networks:
          pretrained:
            encoder:        {config_path: ..., checkpoint_path: ...}
            user_encoder:   {config_path: ..., checkpoint_path: ...}

    The positional table is clipped to the spec's `max_len`, else to the
    model's `token_max_len()`, as the models size their encoders."""
    conf = getattr(model, "conf", None)
    networks = getattr(conf, "networks", None) or {}
    specs = networks.get("pretrained") if isinstance(networks, dict) else None
    if not specs:
        return model
    default_len = (model.token_max_len()
                   if hasattr(model, "token_max_len") else None)
    for module_name, spec in specs.items():
        kwargs = bert_encoder_kwargs(spec["config_path"],
                                     max_len=spec.get("max_len") or default_len)
        params = bert_params_to_flax(
            load_bert_checkpoint(spec["checkpoint_path"]),
            num_layers=kwargs["num_layers"], max_len=kwargs["max_len"],
            num_heads=kwargs["num_heads"])
        graft_params(model, module_name, params)
    return model
