"""Text encoding service: tokenizer + TextEncoder + whitening + LRU cache
(the counterpart of `recommendflow_tpu/encoder/text_encoder.py:25-256`).

Batch text -> embedding with pooling position and output-layer selection,
optional BERT-whitening auto-fit on the first batch, LRU-cached online
encode. `serving/` hosts it over HTTP (`cli/serve.py`), and
`serving.client.RemoteEncoderClient` is the remote client.

The service runs on `device` (default "cuda"; raises without a card unless
"cpu" is asked for). Its weights directory (`save` / `load_weights`) holds
`variables.npz`, the flattened flax variable tree that
`interop.save_variables_npz` writes, and `whitening.npz` once whitening is
fit. The JAX service writes an orbax directory instead; its variables cross
to the port as an .npz of `flax.traverse_util.flatten_dict(variables,
sep="/")` (`interop.py`).
"""
from __future__ import annotations

import os
from collections import OrderedDict, deque
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.encoder.tokenizer import Tokenizer
from recommendflow_tpu_torch.interop import (jax_from_variables,
                                             load_jax_variables,
                                             load_variables_npz,
                                             save_variables_npz)
from recommendflow_tpu_torch.ops.transformer import TextEncoder
from recommendflow_tpu_torch.retrieval.whitening import VecsWhitening

VARIABLES_FILE = "variables.npz"
WHITENING_FILE = "whitening.npz"


class TextEncoderService:
    # batches in flight in _encode_raw: tokenizing batch i + 1 on the host
    # overlaps the card's work on batch i, and at most this many outputs wait
    # in device memory
    WINDOW = 4

    def __init__(self,
                 tokenizer: Tokenizer,
                 model: Optional[TextEncoder] = None,
                 variables=None,
                 max_len: int = 64,
                 batch_size: int = 256,
                 use_whitening: bool = False,
                 whitening_dim: Optional[int] = None,
                 cache_size: int = 100_000,
                 seed: int = 0,
                 device="cuda",
                 **model_kwargs):
        """`variables`: a flax TextEncoder variable tree (numpy) to load into
        the model, e.g. the JAX service's."""
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.batch_size = batch_size
        self.device = resolve_device(device)
        if model is not None and model_kwargs:
            # silently dropping construction options when a model instance
            # is supplied would serve the checkpoint's defaults
            raise TypeError(
                f"model instance given together with construction kwargs "
                f"{sorted(model_kwargs)} — configure the model itself (for "
                "from_pretrained use pool_pos/out_layer)")
        model_kwargs.setdefault("max_len", max_len)
        if model is None:
            model = TextEncoder(vocab_size=len(tokenizer.vocab),
                                device=self.device, seed=seed, **model_kwargs)
        self.model = model.to(self.device).eval()
        if variables is not None:
            load_jax_variables(self.model, variables)
        self.use_whitening = use_whitening
        self.whitening = VecsWhitening(whitening_dim) if use_whitening else None
        self._whitening_fit = False
        self._cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.cache_size = cache_size
        self._buffers = None   # pinned host buffers of _encode_raw, per slot

    # --------------------------------------------------------- pretrained
    @classmethod
    def from_pretrained(cls, config_path: str, checkpoint_path: str,
                        dict_path: str, model_name: str = "base",
                        model_weights_path: Optional[str] = None,
                        max_len: int = 64,
                        pool_pos=None, out_layer: Optional[int] = None,
                        device="cuda",
                        **kwargs) -> "TextEncoderService":
        """A service around a pretrained BERT checkpoint (JAX
        `TextEncoderService.from_pretrained`): `model_name='base'` loads the
        raw checkpoint (optionally overlaid with finetuned weights);
        'cosent'/'sbert' require `model_weights_path`, a directory written
        by `save`. `pool_pos` takes an int position or 'avg'/'max'/'cls'/
        'sum'; `out_layer` selects the nth block's output."""
        from recommendflow_tpu_torch.encoder.pretrained import (
            bert_encoder_kwargs, load_pretrained_text_encoder)
        enc_kwargs: dict = {}
        if pool_pos is not None:
            if isinstance(pool_pos, str):
                if pool_pos not in ("avg", "max", "cls", "sum"):
                    raise ValueError(f"pool_pos not support: {pool_pos}")
                enc_kwargs["pooling"] = pool_pos
            else:
                # bound by the sequence length the encoder will see, not the
                # checkpoint's max_position_embeddings
                n_pos = bert_encoder_kwargs(config_path,
                                            max_len=max_len)["max_len"]
                if not 0 <= int(pool_pos) < n_pos:
                    raise ValueError(
                        f"pool_pos scalar must in [0, {n_pos}), get {pool_pos}")
                enc_kwargs.update(pooling="pos", pool_pos=int(pool_pos))
        if out_layer is not None:
            n_layers = bert_encoder_kwargs(config_path)["num_layers"]
            if not -n_layers <= int(out_layer) < n_layers:
                raise ValueError(
                    f"out_layer must be an int in [-{n_layers}, "
                    f"{n_layers})")
            enc_kwargs["out_layer"] = int(out_layer)
        if model_name.lower() not in ("base", "cosent", "sbert"):
            raise ValueError(f"unsupported model_name='{model_name}'")
        if model_name.lower() != "base" and not model_weights_path:
            raise ValueError(
                f"model_name='{model_name}' requires model_weights_path "
                "(a directory written by TextEncoderService.save)")
        dev = resolve_device(device)
        model, _ = load_pretrained_text_encoder(
            config_path, checkpoint_path, max_len=max_len, device=dev,
            **enc_kwargs)
        service = cls(Tokenizer(dict_path), model=model, max_len=model.max_len,
                      device=dev, **kwargs)
        if model_weights_path:
            service.load_weights(model_weights_path)
        return service

    # ------------------------------------------------------------- encode
    def _slot(self, i: int):
        """Host buffers of pipeline slot i: (token ids, segment ids, output),
        pinned on a card so the copies do not block."""
        if self._buffers is None:
            pin = self.device.type == "cuda"
            shape = (self.batch_size, self.max_len)

            def buf(size, dtype):
                return torch.empty(size, dtype=dtype, pin_memory=pin)

            self._buffers = [(buf(shape, torch.int32), buf(shape, torch.int32),
                              buf((self.batch_size, self.model.model_dim),
                                  torch.float32))
                             for _ in range(self.WINDOW)]
        return self._buffers[i % self.WINDOW]

    @torch.inference_mode()
    def _encode_raw(self, texts: Sequence[str]) -> np.ndarray:
        """The model's vectors of `texts`, batch by batch: each batch is
        padded to `batch_size` with "" rows (one shape for every launch),
        its ids copied to the card without blocking, and its output copied
        back into a pinned buffer; the host waits only for the oldest
        batch's output, once `WINDOW` batches are in flight."""
        on_card = self.device.type == "cuda"
        pending: deque = deque()
        done = []

        def finish():
            out, n, event = pending.popleft()
            if event is not None:
                event.synchronize()
            done.append(out[:n].numpy().copy())

        for i, start in enumerate(range(0, len(texts), self.batch_size)):
            if len(pending) >= self.WINDOW:
                finish()   # frees slot i: its previous batch is done
            chunk = list(texts[start:start + self.batch_size])
            tok, seg = self.tokenizer.encode_batch(
                chunk + [""] * (self.batch_size - len(chunk)), self.max_len)
            tok_h, seg_h, out_h = self._slot(i)
            tok_h.copy_(torch.from_numpy(tok))
            seg_h.copy_(torch.from_numpy(seg))
            emb = self.model(tok_h.to(self.device, non_blocking=True),
                             seg_h.to(self.device, non_blocking=True))
            out_h.copy_(emb, non_blocking=True)
            event = None
            if on_card:
                event = torch.cuda.Event()
                event.record()
            pending.append((out_h, len(chunk), event))
        while pending:
            finish()
        return np.concatenate(done, axis=0)

    def warmup(self) -> None:
        """Run the encode path once before accepting traffic (the kernels
        build at their first launch) WITHOUT touching the LRU cache or
        triggering the whitening auto-fit (a warmup dummy must never become
        the whitening statistics)."""
        self._encode_raw(["warmup"])

    def encode(self, texts: Sequence[str], normalize: bool = True) -> np.ndarray:
        """LRU-cached batch encode. Whitening auto-fits on the first call
        when enabled."""
        if isinstance(texts, (str, bytes)):
            # a bare string satisfies Sequence[str] and would silently
            # encode CHARACTER BY CHARACTER
            raise TypeError("encode() takes a list of texts — wrap the "
                            "single text in a list")
        if len(texts) == 0:
            if self.use_whitening and self._whitening_fit:
                dim = self.whitening.kernel.shape[1]
            elif self.use_whitening and self.whitening is not None \
                    and self.whitening.n_components:
                # not yet fit, but the configured whitening_dim IS the
                # width every non-empty result will have
                dim = self.whitening.n_components
            else:
                dim = self.model.model_dim
            return np.zeros((0, dim), np.float32)
        # snapshot the cached rows this call needs BEFORE any insertion:
        # inserting at capacity evicts LRU entries, which may include them
        have: Dict[str, np.ndarray] = {}
        for t in texts:
            if t not in have and t in self._cache:
                have[t] = self._cache[t]
                self._cache.move_to_end(t)
        missing = [t for t in texts if t not in have]
        fresh: Dict[str, np.ndarray] = {}
        if missing:
            uniq = list(dict.fromkeys(missing))
            embs = self._encode_raw(uniq)
            if self.use_whitening:
                if not self._whitening_fit:
                    if len(embs) < 2:
                        # np.cov of one sample is NaN -> SVD crash; and a
                        # tiny fit batch would silently poison every later
                        # embedding with junk statistics
                        raise ValueError(
                            "whitening auto-fit needs >= 2 texts on the "
                            "first encode call (got "
                            f"{len(embs)}); encode a representative batch "
                            "first, load fitted stats, or use warmup()")
                    self.whitening.fit(embs)
                    self._whitening_fit = True
                embs = self.whitening.transform(embs, normalize=False)
            # keep this call's results OUT of the eviction's reach
            fresh = dict(zip(uniq, embs))
            for t, e in fresh.items():
                if self.cache_size <= 0:
                    break  # caching disabled
                if t not in self._cache and len(self._cache) >= self.cache_size:
                    self._cache.popitem(last=False)
                self._cache[t] = e
        out = np.stack([fresh[t] if t in fresh else have[t] for t in texts])
        if normalize:
            out = out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
        return out

    # ------------------------------------------------------------ persist
    def __getstate__(self):
        """Pickle support (the model pickles as a module, its weights on the
        device they were on); the pinned batch buffers are rebuilt."""
        return {**self.__dict__, "_buffers": None}

    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        save_variables_npz(os.path.join(directory, VARIABLES_FILE),
                           jax_from_variables(self.model.state_dict()))
        if self.whitening is not None and self._whitening_fit:
            self.whitening.save(os.path.join(directory, WHITENING_FILE))

    def load_weights(self, directory: str):
        load_jax_variables(self.model, load_variables_npz(
            os.path.join(directory, VARIABLES_FILE)))
        # embeddings cached under the OLD weights would silently mix two
        # incompatible embedding spaces into one output matrix
        self._cache.clear()
        wpath = os.path.join(directory, WHITENING_FILE)
        if os.path.exists(wpath):
            self.whitening = VecsWhitening.load(wpath)
            self._whitening_fit = True
            self.use_whitening = True
        elif self.use_whitening and self._whitening_fit:
            # statistics fit on the OLD embedding space must not whiten
            # the new weights' embeddings — refit on the next encode
            self.whitening = VecsWhitening(self.whitening.n_components)
            self._whitening_fit = False
        return self
