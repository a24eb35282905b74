"""Nesterov-momentum SGD, the DiLoCo outer optimizer (port of
``repro.optim.nesterov``; paper: outer lr 0.7, momentum 0.9). It steps
on averaged pseudo-gradients ``delta = anchor - theta_i``."""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core.sync_engine import tree_map


class NesterovState(NamedTuple):
    momentum: Any  # fp32 tree, same structure as params


@dataclasses.dataclass(frozen=True)
class NesterovSGD:
    lr: float = 0.7
    momentum: float = 0.9

    def init(self, params) -> NesterovState:
        return NesterovState(tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    def update(self, delta, state: NesterovState, params):
        """theta <- theta - lr * (mu * m_new + delta), m_new = mu * m +
        delta (Nesterov form)."""
        mu = self.momentum

        def upd(d, m, p):
            d = d.float()
            m_new = mu * m + d
            step = mu * m_new + d          # Nesterov look-ahead
            return (p.float() - self.lr * step).to(p.dtype), m_new

        out = tree_map(upd, delta, state.momentum, params)
        return (tree_map(lambda t: t[0], out),
                NesterovState(tree_map(lambda t: t[1], out)))

    def update_flat(self, delta_flat: torch.Tensor, m_flat: torch.Tensor,
                    p_flat: torch.Tensor):
        """Flat-buffer form of ``update`` (the same elementwise math) ->
        (new_p_flat, new_m_flat)."""
        d = delta_flat.float()
        # the same ops as ``update``'s, each rounded alike; written in
        # place on fresh buffers so no third temporary of the flat size
        # is live at once
        m_new = torch.mul(m_flat, self.momentum).add_(d)
        step = torch.mul(m_new, self.momentum).add_(d)   # look-ahead
        return torch.sub(p_flat, step.mul_(self.lr)), m_new
