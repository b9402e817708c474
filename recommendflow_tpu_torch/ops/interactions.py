"""Feature-interaction layers: FM family, CrossNetwork, CIN, residual units
(the counterpart of `recommendflow_tpu/ops/interactions.py`).

`nn.Module`s over dense [B, F, D] field-embedding tensors or [B, D] vectors,
built with their input widths. Dense layers carry the flax names (`linear`,
`Dense_i`); bare flax parameters (`w{i}`, `b{i}`, `field_latents`) keep their
names and flax layouts as `nn.Parameter`s, drawn from the given generator
(flax's normal(0.05) and zeros), so `interop.py` carries them one to one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from recommendflow_tpu_torch.utils.profiling import mark_region


def _normal(shape, generator: Optional[torch.Generator], device,
            std: float = 0.05) -> nn.Parameter:
    t = torch.empty(shape, device=device)
    t.normal_(0.0, std, generator=generator)
    return nn.Parameter(t)


def fm_pairwise(emb: torch.Tensor) -> torch.Tensor:
    """Second-order FM interaction over field embeddings [B, F, D] -> [B]:
    0.5 * sum((Σv)² − Σv²) (the square-of-sum trick)."""
    sum_sq = torch.sum(emb, dim=1) ** 2
    sq_sum = torch.sum(emb ** 2, dim=1)
    return 0.5 * torch.sum(sum_sq - sq_sum, dim=-1)


class FM(nn.Module):
    """First + second order factorization machine over looked-up field
    embeddings [B, F, D]. Optional field_values [B, F] scale each field's
    embedding (weighted FM for numeric-valued fields) before both terms."""

    def __init__(self, num_fields: int, dim: int, device=None):
        super().__init__()
        self.linear = nn.Linear(num_fields * dim, 1, device=device)

    def forward(self, field_emb: torch.Tensor,
                field_values: Optional[torch.Tensor] = None) -> torch.Tensor:
        if field_values is not None:
            field_emb = field_emb * field_values[..., None]
        b, f, d = field_emb.shape
        first = self.linear(field_emb.reshape(b, f * d))[:, 0]
        return first + fm_pairwise(field_emb)


class FFM(nn.Module):
    """Field-aware FM: per-field-pair latent vectors, O(F²) pairs."""

    def __init__(self, num_fields: int, dim: int, latent_dim: int = 8,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.field_latents = _normal((num_fields, num_fields, dim, latent_dim),
                                     generator, device)

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        f = field_emb.shape[1]
        # v[i,j] = emb_i @ w[i,j]; score = sum_{i<j} v[i,j]·v[j,i]
        proj = torch.einsum("bfd,fgdk->bfgk", field_emb, self.field_latents)
        inter = torch.einsum("bfgk,bgfk->bfg", proj, proj)
        iu = torch.triu_indices(f, f, offset=1, device=field_emb.device)
        return torch.sum(inter[:, iu[0], iu[1]], dim=-1)


class ResidualUnits(nn.Module):
    """Deep Crossing residual block: relu(Dense_1(relu(Dense_0(x))) + x)."""

    def __init__(self, in_dim: int, hidden: int, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, hidden, device=device)
        self.Dense_1 = nn.Linear(hidden, in_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.Dense_1(F.relu(self.Dense_0(x))) + x)


class CrossNetwork(nn.Module):
    """DCN explicit crossing: x_{l+1} = x0 * (x_l · w_l) + b_l + x_l."""

    def __init__(self, dim: int, num_layers: int = 3,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.register_parameter(f"w{i}", _normal((dim, 1), generator, device))
            self.register_parameter(
                f"b{i}", nn.Parameter(torch.zeros(dim, device=device)))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for i in range(self.num_layers):
            xw = x @ getattr(self, f"w{i}")            # [B, 1]
            x = x0 * xw + getattr(self, f"b{i}") + x
        return x


class LowRankCrossNet(nn.Module):
    """DCN-V2's low-rank matrix cross (Wang et al. 2021, arXiv 2008.13535):
    x_{l+1} = x0 * (U_l (V_l x_l) + b_l) + x_l, with V_l [rank, width]
    (`V_{l}`, no bias) and U_l [width, rank] with its bias b_l (`U_{l}`),
    both nn.Linear so that `models.base.init_dense_` draws them.

    Under autograd the card marks where the cross's forward starts and
    ends and where its backward starts and ends (hooks on its output's and
    x0's gradients): `utils/profiling.py:mark_region`, which launches only
    while spans are recorded or a graph captures."""

    def __init__(self, width: int, num_layers: int = 3, rank: int = 512,
                 device=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"V_{i}", nn.Linear(width, rank, bias=False,
                                                device=device))
            self.add_module(f"U_{i}", nn.Linear(rank, width, device=device))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        marked = x0.requires_grad and torch.is_grad_enabled()
        if marked:
            mark_region(x0.device, "cross_forward")
            x0.register_hook(_marker_hook(x0.device, "cross_backward_end"))
        x = x0
        for i in range(self.num_layers):
            u = getattr(self, f"U_{i}")(getattr(self, f"V_{i}")(x))
            x = x0 * u + x
        if marked:
            mark_region(x0.device, "cross_forward_end")
            x.register_hook(_marker_hook(x0.device, "cross_backward"))
        return x


def _marker_hook(device: torch.device, region: str):
    """A gradient hook that marks `region` on the card and leaves the
    gradient as it is."""
    def hook(grad):
        mark_region(device, region)
    return hook


class CIN(nn.Module):
    """xDeepFM compressed interaction network over [B, F, D]: each layer
    h^k = conv(outer(h^{k-1}, h^0)); the output is the concat of the
    per-layer sum-pooled feature maps. split_half=True (the xDeepFM paper's
    variant) sends half of each non-final layer forward and pools the other
    half; activation 'relu' or 'linear' (the reference's raw conv1d
    stack with split_half=False)."""

    def __init__(self, num_fields: int, layer_sizes: Sequence[int] = (128, 128),
                 split_half: bool = True, activation: str = "relu",
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if activation not in ("relu", "linear"):
            raise ValueError(f"CIN activation '{activation}' (relu|linear)")
        self.layer_sizes = list(layer_sizes)
        self.split_half = split_half
        self.activation = activation
        fk, self.out_dim = num_fields, 0
        last = len(self.layer_sizes) - 1
        for li, size in enumerate(self.layer_sizes):
            self.register_parameter(
                f"w{li}", _normal((fk * num_fields, size), generator, device))
            if split_half and li != last:
                self.out_dim += size // 2
                fk = size - size // 2
            else:
                self.out_dim += size
                fk = size

    def forward(self, field_emb: torch.Tensor) -> torch.Tensor:
        b, f0, d = field_emb.shape
        h = field_emb
        outputs = []
        last = len(self.layer_sizes) - 1
        for li, size in enumerate(self.layer_sizes):
            fk = h.shape[1]
            z = torch.einsum("bfd,bgd->bfgd", h, field_emb)     # [B, Fk, F0, D]
            h_next = torch.einsum("bpd,ps->bsd", z.reshape(b, fk * f0, d),
                                  getattr(self, f"w{li}"))     # [B, size, D]
            if self.activation == "relu":
                h_next = F.relu(h_next)
            if self.split_half and li != last:
                half = size // 2
                direct, h = h_next[:, :half], h_next[:, half:]
            else:
                direct, h = h_next, h_next
            outputs.append(torch.sum(direct, dim=-1))
        return torch.cat(outputs, dim=-1)
