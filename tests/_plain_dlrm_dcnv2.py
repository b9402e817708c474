"""A plain DLRM-DCNv2 in float32 PyTorch, the CPU tests' yardstick for the
port's `DlrmDcnV2` (tests/test_torch_dlrm_dcnv2.py). It imports neither JAX
nor any module of the port, and runs with TF32 off (`exact_float32`).

The model, as MLPerf Training's DLRM-DCNv2 (torchrec's `DLRM_DCN`, in the
mlcommons/training `recommendation_v2/torchrec_dlrm` reference) defines it:
the dense fields through a bottom MLP with ReLU after every layer; each
sparse field's multi-hot bag sum-pooled from its embedding table; x0 the
bottom output followed by the pooled fields in field order; three (here
`len(cross)`) low-rank cross layers x_{l+1} = x0 * (U_l (V_l x_l) + b_l) +
x_l; a top MLP with ReLU after every layer and a linear head to one logit;
the mean binary cross-entropy on the logit.

Departures from the source, each the port's as well:
  * id 0 of every field is a pad row, zero, left out of the bag's sum
    (the source's bags hold no pad);
  * the fields' tables are stacked into one [rows, dim] table, field after
    field (`offsets`), so a row's gradient is the stacked table's;
  * the tables train by row-wise Adagrad, one accumulator per `pack`
    consecutive stacked rows (the port's stored row), seeded at 0.1:
    acc += mean(g^2) over the stored row, row -= lr * g / sqrt(acc + 1e-10),
    in float32 and rounded once to the table's dtype; the dense layers by
    Adam (bias-corrected, eps outside the root); the source runs Adagrad
    on both.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

ADAGRAD_INIT = 0.1
ADAGRAD_EPS = 1e-10


@contextlib.contextmanager
def exact_float32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def gathered(table: torch.Tensor, offsets: Sequence[int],
             sparse: Sequence[str], batch: Mapping[str, torch.Tensor]
             ) -> List[torch.Tensor]:
    """Each sparse field's bag [B, ..., L] of ids -> its rows [B, L, dim] in
    float32, one per id (the pads' too)."""
    out = []
    for name, off in zip(sparse, offsets):
        ids = batch[name].long().reshape(batch[name].shape[0], -1)
        out.append(table[ids + off].float())
    return out


def pooled(rows: Sequence[torch.Tensor], sparse: Sequence[str],
           batch: Mapping[str, torch.Tensor]) -> List[torch.Tensor]:
    """Each field's gathered rows [B, L, dim] -> [B, dim]: the rows of its
    not-pad ids (id > 0) summed."""
    out = []
    for name, r in zip(sparse, rows):
        ids = batch[name].reshape(batch[name].shape[0], -1)
        out.append((r * (ids > 0)[..., None].float()).sum(dim=1))
    return out


def logits(p: Mapping[str, torch.Tensor], rows: Sequence[torch.Tensor],
           sparse: Sequence[str], dense: Sequence[str],
           batch: Mapping[str, torch.Tensor], bottom: int, cross: int,
           top: int) -> torch.Tensor:
    """[B] logits from each field's gathered rows (`gathered`); `p` holds
    bottom{i}.weight/bias, cross{l}.V/U/bias, top{i}.weight/bias and
    head.weight/bias (nn.Linear's layouts)."""
    h = torch.cat([batch[n].float().reshape(batch[n].shape[0], -1)
                   for n in dense], dim=-1)
    for i in range(bottom):
        h = torch.relu(h @ p[f"bottom{i}.weight"].t() + p[f"bottom{i}.bias"])
    x0 = torch.cat([h] + pooled(rows, sparse, batch), dim=-1)
    x = x0
    for i in range(cross):
        u = (x @ p[f"cross{i}.V"].t()) @ p[f"cross{i}.U"].t() + p[f"cross{i}.bias"]
        x = x0 * u + x
    for i in range(top):
        x = torch.relu(x @ p[f"top{i}.weight"].t() + p[f"top{i}.bias"])
    return (x @ p["head.weight"].t() + p["head.bias"])[:, 0]


def bce(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


class Adam:
    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> None:
        self.t += 1
        for k, g in grads.items():
            m = self.b1 * self.m.get(k, torch.zeros_like(g)) + (1 - self.b1) * g
            v = self.b2 * self.v.get(k, torch.zeros_like(g)) + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            denom = torch.sqrt(v) / math.sqrt(1 - self.b2 ** self.t) + self.eps
            params[k] = params[k] - self.lr / (1 - self.b1 ** self.t) * m / denom


def rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, grad: torch.Tensor,
                    pack: int, lr: float) -> torch.Tensor:
    """The table after one row-wise Adagrad step on the stored rows whose
    gradient is not all zero; `acc` [stored rows] is updated in place."""
    dim = table.shape[1]
    g = grad.reshape(-1, pack * dim)
    touched = torch.nonzero(g.abs().sum(dim=1) > 0)[:, 0]
    gt = g[touched]
    a = acc[touched] + (gt * gt).mean(dim=1)
    acc[touched] = a
    stored = table.float().reshape(-1, pack * dim).clone()
    stored[touched] = stored[touched] - lr * gt * torch.rsqrt(a + ADAGRAD_EPS)[:, None]
    return stored.reshape(table.shape).to(table.dtype)


def train_steps(p: Dict[str, torch.Tensor], table: torch.Tensor,
                offsets: Sequence[int], sparse: Sequence[str],
                dense: Sequence[str], label: str,
                batches: Sequence[Mapping[str, torch.Tensor]],
                arch: Tuple[int, int, int], pack: int, lr: float,
                table_lr: float):
    """Steps of Adam on the dense layers and row-wise Adagrad on the table,
    one per batch: (losses, dense parameters, table)."""
    p = {k: v.clone() for k, v in p.items()}
    acc = torch.full((table.shape[0] // pack,), ADAGRAD_INIT)
    adam = Adam(lr)
    losses = []
    with exact_float32():
        for b in batches:
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            t = table.detach().float().requires_grad_()
            rows = gathered(t, offsets, sparse, b)
            loss = bce(logits(leaves, rows, sparse, dense, b, *arch),
                       b[label].float())
            loss.backward()
            losses.append(float(loss.detach()))
            adam.step(p, {k: v.grad for k, v in leaves.items()})
            table = rowwise_adagrad(table, acc, t.grad, pack, table_lr)
    return losses, p, table
