"""Transformer blocks, the compact BERT-style text encoder, the
TabTransformer blocks and the ViT-style image encoder (the counterpart of
`recommendflow_tpu/ops/transformer.py`).

Submodules carry the flax names (`tok_emb`, `seg_emb`, `pos_emb`, `emb_ln`,
`block{i}.mha.{q,k,v,out}`, `block{i}.ln1`, `block{i}.ffn.Dense_{0,1}`,
`block{i}.ln2`), so `interop.py` maps a flax `TextEncoder` tree onto the
state dict one to one (`TabTransformer`: `block{i}.…` likewise;
`ImageEncoder`: `patch_proj`, `cls`, `pos_emb`, `emb_ln`, `block{i}`,
`head`). Training
mode follows the module's `train()`/`eval()` state (dropout drops only in
training). Parameters and activations are f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from recommendflow_tpu_torch.device import resolve_device
from recommendflow_tpu_torch.ops.attention import (MultiHeadAttention,
                                                   sinusoidal_position_encoding)
from recommendflow_tpu_torch.ops.embedding import IMAGE_PATCH, patchify
from recommendflow_tpu_torch.ops.mlp import get_activation

POOLINGS = ("cls", "pos", "avg", "sum", "max")


class FeedForward(nn.Module):
    """Position-wise FFN: Dense_0 -> activation -> dropout -> Dense_1."""

    def __init__(self, in_dim: int, hidden: int, out_dim: Optional[int] = None,
                 dropout: float = 0.0, activation: str = "gelu", device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, out_dim or in_dim, device=device)
        self.activation = activation   # a name, so the module pickles
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = get_activation(self.activation)
        return self.Dense_1(self.drop(act(self.Dense_0(x))))


class TransformerEncoderBlock(nn.Module):
    """MHA + residual + LayerNorm, FFN + residual + LayerNorm (post-LN, as
    BERT)."""

    def __init__(self, model_dim: int, num_heads: int, ffn_hidden: int,
                 dropout: float = 0.0, head_dim: Optional[int] = None,
                 ffn_activation: str = "gelu", ln_epsilon: float = 1e-6,
                 device=None):
        super().__init__()
        self.mha = MultiHeadAttention(model_dim, num_heads, head_dim=head_dim,
                                      device=device)
        self.ln1 = nn.LayerNorm(model_dim, eps=ln_epsilon, device=device)
        self.ffn = FeedForward(model_dim, ffn_hidden, dropout=dropout,
                               activation=ffn_activation, device=device)
        self.ln2 = nn.LayerNorm(model_dim, eps=ln_epsilon, device=device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.ln1(x + self.drop(self.mha(x, x, x, mask)))
        return self.ln2(x + self.drop(self.ffn(x)))


class TextEncoder(nn.Module):
    """Token + segment + position embeddings, `num_layers` encoder blocks,
    then pooling (cls | pos | avg | sum | max) of block `out_layer`'s output.

    The constructor takes the JAX module's fields plus `device` (default
    "cuda"; raises without a card unless "cpu" is asked for) and `seed`
    (weights from a torch.Generator: flax's initialisers in kind, not in
    numbers). The module starts in eval mode."""

    def __init__(self, vocab_size: int, num_layers: int = 4,
                 model_dim: int = 256, num_heads: int = 4,
                 ffn_hidden: int = 1024, max_len: int = 64,
                 dropout: float = 0.1, pooling: str = "cls",
                 out_layer: int = -1, pool_pos: int = 0,
                 pos_type: str = "sinusoidal", type_vocab_size: int = 2,
                 ln_epsilon: float = 1e-6, ffn_activation: str = "gelu",
                 device="cuda", seed: int = 0):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling '{pooling}'")
        dev = resolve_device(device)
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.model_dim, self.num_heads = model_dim, num_heads
        self.max_len, self.pooling = max_len, pooling
        self.out_layer, self.pool_pos = out_layer, pool_pos
        self.pos_type = pos_type
        self.tok_emb = nn.Embedding(vocab_size, model_dim, device=dev)
        self.seg_emb = nn.Embedding(type_vocab_size, model_dim, device=dev)
        if pos_type == "learned":
            self.pos_emb = nn.Parameter(torch.empty(max_len, model_dim,
                                                    device=dev))
        self.emb_ln = nn.LayerNorm(model_dim, eps=ln_epsilon, device=dev)
        self.drop = nn.Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"block{i}", TransformerEncoderBlock(
                model_dim, num_heads, ffn_hidden, dropout,
                ffn_activation=ffn_activation, ln_epsilon=ln_epsilon,
                device=dev))
        self._init(torch.Generator(device=dev).manual_seed(seed))
        self.eval()

    @torch.no_grad()
    def _init(self, gen: torch.Generator) -> None:
        """flax's defaults: Dense kernels lecun_normal (truncated normal of
        variance 1/fan_in), biases 0; Embed rows normal of variance
        1/model_dim; the learned positions normal(0.02); LayerNorm 1 and 0."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(self.model_dim),
                                 generator=gen)
        if self.pos_type == "learned":
            self.pos_emb.normal_(0.0, 0.02, generator=gen)

    def forward(self, token_ids: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                seq2seq: bool = False,
                return_sequence: bool = False) -> torch.Tensor:
        """token_ids [B, L] (0 = pad) -> [B, model_dim] pooled, or the
        [B, L, model_dim] hidden states with return_sequence=True.

        seq2seq=True applies the UniLM mask of SimBERT training, built on
        the device from the ids: key j is visible to query i iff j is a real
        token and (j is in segment 0 or j <= i). It reaches SDPA as a full
        [B, 1, L, L] mask, which runs the vanilla maths (kernel 6 takes key
        masks only)."""
        length = token_ids.shape[1]
        if length > self.max_len:
            raise ValueError(
                f"sequence length {length} exceeds the encoder's configured "
                f"max_len={self.max_len} — truncate at tokenization "
                "(Tokenizer.encode_batch maxlen)")
        token_ids = token_ids.long()
        mask = token_ids > 0
        seg = (segment_ids.long() if segment_ids is not None
               else torch.zeros_like(token_ids))
        x = self.tok_emb(token_ids) + self.seg_emb(seg)
        if self.pos_type == "learned":
            x = x + self.pos_emb[None, :length]
        else:
            x = x + sinusoidal_position_encoding(length, self.model_dim,
                                                 x.dtype, x.device)[None]
        x = self.drop(self.emb_ln(x))
        attn_mask = mask
        if seq2seq:
            pos = torch.arange(length, device=token_ids.device)
            tri = pos[:, None] >= pos[None, :]                # [i, j]: j <= i
            attn_mask = mask[:, None, :] & ((seg == 0)[:, None, :] | tri[None])
        outputs = []
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, attn_mask)
            outputs.append(x)
        out = outputs[self.out_layer]
        if return_sequence:
            return out
        m = mask[..., None].to(out.dtype)
        if self.pooling == "cls":
            return out[:, 0]
        if self.pooling == "pos":
            return out[:, self.pool_pos]
        if self.pooling == "avg":
            return (out * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
        if self.pooling == "sum":
            return (out * m).sum(dim=1)
        return torch.where(m > 0, out, torch.full_like(out, -1e9)).amax(dim=1)


class TabTransformer(nn.Module):
    """`num_blocks` post-LN encoder blocks over field embeddings [B, F, D]
    with no mask, flattened to [B, F*D] (`block{i}`, as flax names them)."""

    def __init__(self, model_dim: int, num_blocks: int = 2, num_heads: int = 4,
                 ffn_hidden: int = 256, dropout: float = 0.1, device=None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", TransformerEncoderBlock(
                model_dim, num_heads, ffn_hidden, dropout, device=device))

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        x = field_emb
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x.reshape(x.shape[0], -1)


class ImageEncoder(nn.Module):
    """ViT-style image encoder: [B, S, S, 3] pixels -> 8x8 patches ->
    `patch_proj` -> a zero-initialised [CLS] (`cls` [1, 1, D]) prepended,
    learned positions added (`pos_emb` [1, (S/8)^2 + 1, D], normal(0.02)) ->
    `emb_ln` -> dropout -> `num_layers` encoder blocks with no mask (a patch
    grid has no padding) -> pooled (the [CLS] row, or the mean over rows
    with pooling "avg") -> `head` [B, out_dim].

    The JAX module reads S off its input; here `image_size` sizes the
    positional table. Its Linear layers are drawn by the owning model
    (`init_dense_`), `pos_emb` from `generator`."""

    def __init__(self, image_size: int, out_dim: int = 128,
                 patch: int = IMAGE_PATCH, num_layers: int = 2,
                 model_dim: int = 128, num_heads: int = 4,
                 ffn_hidden: int = 512, dropout: float = 0.1,
                 pooling: str = "cls",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if pooling not in ("cls", "avg"):
            raise ValueError(f"unknown pooling '{pooling}' (cls | avg)")
        n = image_size // patch
        self.patch, self.num_layers, self.pooling = patch, num_layers, pooling
        self.patch_proj = nn.Linear(patch * patch * 3, model_dim,
                                    device=device)
        self.cls = nn.Parameter(torch.zeros((1, 1, model_dim), device=device))
        self.pos_emb = nn.Parameter(torch.empty((1, n * n + 1, model_dim),
                                                device=device))
        self.emb_ln = nn.LayerNorm(model_dim, eps=1e-6, device=device)
        self.drop = nn.Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"block{i}", TransformerEncoderBlock(
                model_dim, num_heads, ffn_hidden, dropout, device=device))
        self.head = nn.Linear(model_dim, out_dim, device=device)
        with torch.no_grad():
            self.pos_emb.normal_(0.0, 0.02, generator=generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_proj(patchify(images, self.patch))        # [B, N, D]
        cls = self.cls.expand(x.shape[0], -1, -1)
        x = self.drop(self.emb_ln(torch.cat([cls, x], dim=1) + self.pos_emb))
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x)
        pooled = x[:, 0] if self.pooling == "cls" else x.mean(dim=1)
        return self.head(pooled)
