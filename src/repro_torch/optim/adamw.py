"""AdamW, the DiLoCo inner optimizer (port of ``repro.optim.adamw``;
paper: lr 7.5e-5, b1 0.9, b2 0.95, weight decay 0.1). Moments are fp32
whatever the parameter dtype; each update computes in fp32 and casts the
new parameter back to its dtype, as the JAX package does.

``update`` is functional like the reference; ``update_`` writes the same
values into the parameters and moments in place (the trainer's path,
one leaf at a time, so no second copy of the model or its moments is
held)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.sync_engine import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable = 1e-3      # float or schedule(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        some = leaves(params)[0]
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        return AdamWState(torch.zeros((), dtype=torch.int32,
                                      device=some.device),
                          zeros, tree_map(torch.clone, zeros))

    def _coeffs(self, step: torch.Tensor):
        """(lr, bias corrections) for the new ``step``, in fp32."""
        lr = self.lr(step) if callable(self.lr) else self.lr
        sf = step.float()
        c1 = 1 - torch.tensor(self.b1, dtype=torch.float32,
                              device=step.device) ** sf
        c2 = 1 - torch.tensor(self.b2, dtype=torch.float32,
                              device=step.device) ** sf
        return lr, c1, c2

    def _leaf(self, g, m, v, p, lr, c1, c2):
        """New (p, m, v) of one leaf, the reference's fp32 arithmetic."""
        b1, b2 = self.b1, self.b2
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + self.eps)
        delta = delta + self.weight_decay * p.float()
        new_p = p.float() - lr * delta
        return new_p.to(p.dtype), m, v

    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        lr, c1, c2 = self._coeffs(step)
        out = tree_map(lambda g, m, v, p: self._leaf(g, m, v, p, lr, c1, c2),
                       grads, state.m, state.v, params)
        pick = lambda i: tree_map(lambda t: t[i], out)
        return pick(0), AdamWState(step, pick(1), pick(2))

    @torch.no_grad()
    def update_(self, grads, state: AdamWState, params) -> None:
        """``update`` written into ``params``, ``state.m``, ``state.v``
        and ``state.step`` in place."""
        step = state.step + 1
        lr, c1, c2 = self._coeffs(step)
        for g, m, v, p in zip(leaves(grads), leaves(state.m),
                              leaves(state.v), leaves(params)):
            new_p, new_m, new_v = self._leaf(g, m, v, p, lr, c1, c2)
            p.copy_(new_p)
            m.copy_(new_m)
            v.copy_(new_v)
        state.step.copy_(step)
