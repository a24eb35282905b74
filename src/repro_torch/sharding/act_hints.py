"""Activation-sharding hints (port of ``repro.sharding.act_hints``).

Model code is mesh-agnostic; the step builder knows the plan. The
reference bridges them with a sharding constraint on the (B, S, D)
residual stream, which XLA's partitioner reads while it traces a step
(``hint_residual``). Here a rank runs its own part of the step eagerly,
so the hint says what that part is, and the few model functions whose
result depends on the rest of the batch or sequence read it:

  * ``BatchSplit``: a worker's activation batch is split over a group of
    ranks (the FSDP train step). A token-choice MoE layer routes over
    the whole batch, as the reference's does: it gathers the routing
    scores of the group in the reference's row order
    (``models.moe.apply_moe``);
  * ``SeqSplit``: a serving prefill whose sequence is split over
    'model' (``train.step.build_serve_step`` when the KV heads do not
    divide that axis). This rank runs the residual stream of positions
    [lo, hi); attention gathers K/V over the group, and the last prompt
    token's state comes from the rank that holds it
    (``models.transformer``).

Outside ``activation_hints`` (and with a hint that has neither) every
model function is bit for bit what it is without this module. The
collectives are the step's, handed in as callables, so this module and
the model code import nothing of ``torch.distributed``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """This rank holds rows [index * n, (index + 1) * n) of a batch split
    in ``size`` equal blocks. ``gather(t)`` concatenates the group's
    ``t`` (one block's rows each) along dim 0 in row order; its backward
    takes the SUM of every rank's gradient of the result and returns
    this rank's rows of it."""
    index: int
    size: int
    gather: Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """This rank runs positions ``bounds[index]`` = [lo, hi) of a
    sequence split over a group (``bounds`` in rank order; uneven splits
    allowed). ``all_gather(t)`` returns the list of the group's ``t``
    (equal shapes), forward only."""
    index: int
    bounds: tuple
    all_gather: Callable[[torch.Tensor], list]

    @property
    def lo(self) -> int:
        return self.bounds[self.index][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.index][1]

    def gather_seq(self, t: torch.Tensor) -> torch.Tensor:
        """(B, hi - lo, ...) -> (B, S, ...): every rank's positions, in
        order (blocks padded to the longest for the exchange)."""
        width = max(h - l for l, h in self.bounds)
        pad = width - t.shape[1]
        if pad:
            t = torch.cat([t, t.new_zeros((t.shape[0], pad)
                                          + tuple(t.shape[2:]))], dim=1)
        parts = self.all_gather(t.contiguous())
        return torch.cat([p[:, :h - l] for p, (l, h)
                          in zip(parts, self.bounds)], dim=1)

    def pick(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (B, hi - lo, D) this rank's positions, pos (B,) global
        positions -> (B, 1, D): row ``pos[b]`` of slot b, from the rank
        that holds it (exact: a selection, no sum)."""
        b, _, d = x.shape
        loc = (pos.long() - self.lo).clamp(0, x.shape[1] - 1)
        mine = torch.gather(x, 1, loc[:, None, None].expand(b, 1, d))
        parts = torch.stack(self.all_gather(mine.contiguous()))
        owner = torch.zeros_like(pos, dtype=torch.long)
        for r, (l, h) in enumerate(self.bounds):
            owner = torch.where((pos >= l) & (pos < h), r, owner)
        rows = torch.arange(b, device=x.device)
        return parts[owner.to(parts.device), rows.to(parts.device)]


@dataclasses.dataclass(frozen=True)
class Hint:
    batch: BatchSplit | None = None
    seq: SeqSplit | None = None


def even_bounds(s: int, n: int) -> tuple:
    """[lo, hi) of each of ``n`` ranks over ``s`` positions: contiguous,
    sizes differing by at most one, none empty while s >= n."""
    return tuple((r * s // n, (r + 1) * s // n) for r in range(n))


_HINT: Hint | None = None


@contextlib.contextmanager
def activation_hints(hint: Hint | None):
    """Activate ``hint`` while a step runs (None: no hint)."""
    global _HINT
    prev = _HINT
    _HINT = hint
    try:
        yield
    finally:
        _HINT = prev


def batch_split() -> BatchSplit | None:
    """The active batch split, if any."""
    return None if _HINT is None else _HINT.batch


def seq_split() -> SeqSplit | None:
    """The active sequence split, if any."""
    return None if _HINT is None else _HINT.seq
