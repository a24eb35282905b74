"""The two optimizers of DiLoCo, element by element in fp32: AdamW for a
worker's inner steps (parameters kept in their stored dtype, moments in
fp32) and Nesterov momentum SGD for the outer step on the anchor."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float


@torch.no_grad()
def adamw_step(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, step: int, c: AdamWConfig) -> None:
    """One AdamW step of one tensor, in place: ``m`` and ``v`` (fp32)
    and ``p`` (rounded back to its dtype). ``step`` counts from 1."""
    g = g.float()
    m.mul_(c.b1).add_(g, alpha=1 - c.b1)
    v.mul_(c.b2).addcmul_(g, g, value=1 - c.b2)
    mhat = m / (1 - c.b1 ** step)
    vhat = v / (1 - c.b2 ** step)
    pf = p.float()
    upd = mhat / (vhat.sqrt() + c.eps) + c.weight_decay * pf
    p.copy_(pf - c.lr * upd)


@torch.no_grad()
def nesterov_step(anchor: torch.Tensor, mom: torch.Tensor,
                  delta: torch.Tensor, lr: float, mu: float) -> None:
    """anchor -= lr * (mu * m' + delta), m' = mu * m + delta; in place
    on the fp32 anchor and momentum."""
    mom.mul_(mu).add_(delta)
    anchor.sub_(lr * (mu * mom + delta))
