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
  * ``SeqSplit``: the residual stream is split by position over
    'model'. This rank runs positions [lo, hi); attention gathers K/V
    over the group. In a serving prefill (``train.step.
    build_serve_step`` when the KV heads do not divide that axis) the
    gather is forward only and the last prompt token's state comes from
    the rank that holds it (``models.transformer``). In the
    sequence-parallel train step (``train.step.build_train_step`` under
    ``plan.act_seq_axis``) the split carries a ``reduce_scatter``, so
    its gather has a backward: each rank's gradient of the whole
    sequence, summed over the group, back at this rank's positions;
  * ``GridSplit``: the sequence-parallel train step's (B, S) token grid
    of a worker, split over rows by the batch axes and over positions
    by 'model': the MoE routing's gather in the reference's b-major
    token order;
  * ``LossSplit``: the loss of a worker's (micro)batch split over its
    ranks: each rank's term is its tokens' masked sum over the mask sum
    of the whole (micro)batch (``common.cross_entropy_max_z``), so the
    terms add up to the reference's one loss.

Outside ``activation_hints`` (and with a hint that has none of them)
every model function is bit for bit what it is without this module. The
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

    def mine(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t``, the group's whole (gathered) rows."""
        n = t.shape[0] // self.size
        return t[self.index * n:(self.index + 1) * n]


def _pad_dim(t: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    """``t`` padded with zeros along ``dim`` to ``width``."""
    pad = width - t.shape[dim]
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """This rank runs positions ``bounds[index]`` = [lo, hi) of a
    sequence split over a group (``bounds`` in rank order; uneven splits
    allowed). ``all_gather(t)`` returns the list of the group's ``t``
    (equal shapes), forward only. ``reduce_scatter(rows)`` (training;
    None when serving) returns the sum over the group's ranks of each
    one's ``rows[index]`` (rows (n, ...): row r goes to rank r): with
    it, ``gather_seq`` has a backward."""
    index: int
    bounds: tuple
    all_gather: Callable[[torch.Tensor], list]
    reduce_scatter: Callable[[torch.Tensor], torch.Tensor] | None = None

    @property
    def lo(self) -> int:
        return self.bounds[self.index][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.index][1]

    def over(self, s: int) -> "SeqSplit":
        """The split laid evenly over ``s`` positions (``even_bounds``):
        a training model lays it over each stream it runs (a VLM's
        frontend and tokens, an enc-dec's source and target)."""
        return dataclasses.replace(self, bounds=even_bounds(
            s, len(self.bounds)))

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        width = max(h - l for l, h in self.bounds)
        parts = self.all_gather(_pad_dim(t, 1, width).contiguous())
        return torch.cat([p[:, :h - l] for p, (l, h)
                          in zip(parts, self.bounds)], dim=1)

    def gather_seq(self, t: torch.Tensor) -> torch.Tensor:
        """(B, hi - lo, ...) -> (B, S, ...): every rank's positions, in
        order (blocks padded to the longest for the exchange). With a
        ``reduce_scatter`` its backward takes every rank's gradient of
        the whole, summed over the group (a padded reduce-scatter), at
        this rank's positions."""
        if self.reduce_scatter is None:
            return self._gather(t)
        return _GatherSeq.apply(t, self)

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


class _GatherSeq(torch.autograd.Function):
    """``SeqSplit.gather_seq`` with its backward."""

    @staticmethod
    def forward(ctx, t, split):
        ctx.split = split
        return split._gather(t)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.split
        width = max(h - l for l, h in sp.bounds)
        mine = sp.reduce_scatter(torch.stack(
            [_pad_dim(g[:, l:h], 1, width) for l, h in sp.bounds]))
        return mine[:, :sp.hi - sp.lo], None


@dataclasses.dataclass(frozen=True)
class GridSplit:
    """A worker's (B, S) token grid split over a group: the group's rank
    r holds rows ``rows[r]`` and positions ``cols[r]`` (each [lo, hi);
    ``cols`` from ``over``), and its tokens flattened b-major over that
    block. ``seq_of[r]`` is rank r's index in the sequence split, which
    lays ``n_seq`` blocks. ``all_gather`` / ``reduce_scatter`` are the
    group's, as ``SeqSplit``'s."""
    index: int
    rows: tuple
    seq_of: tuple
    n_seq: int
    all_gather: Callable[[torch.Tensor], list]
    reduce_scatter: Callable[[torch.Tensor], torch.Tensor]
    cols: tuple = ()

    @property
    def size(self) -> int:
        return len(self.rows)

    def over(self, s: int) -> "GridSplit":
        """The split with its positions laid evenly over ``s``."""
        b = even_bounds(s, self.n_seq)
        return dataclasses.replace(self, cols=tuple(b[q]
                                                    for q in self.seq_of))

    def _shape(self) -> tuple:
        return (max(a1 for _, a1 in self.rows),
                max(hi for _, hi in self.cols))

    def _tiles(self, device) -> tuple:
        """The grid as tiles, each rank's block padded to the longest
        block's width: (the ranks in tile order (row block major, then
        position block), each tile's rank-order place, each position's
        column in the position blocks laid side by side)."""
        width = max(h - l for l, h in self.cols)
        order = sorted(range(self.size),
                       key=lambda r: (self.rows[r][0], self.cols[r][0]))
        place = torch.empty(self.size, dtype=torch.long)
        place[torch.tensor(order)] = torch.arange(self.size)
        cols = torch.cat([torch.arange(q * width, q * width + h - l)
                          for q, (l, h) in enumerate(even_bounds(
                              self._shape()[1], self.n_seq))])
        return order, place.to(device), cols.to(device), width

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(T_local, ...) this rank's tokens -> (B * S, ...) the group's,
        b-major (the reference's token order). Backward: the sum over
        the group's ranks of their gradients of the whole, at this
        rank's tokens."""
        return _GatherGrid.apply(t, self)

    def mine(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's tokens (b-major over its block) of ``t``, the
        whole grid's (B * S, ...)."""
        (r0, r1), (lo, hi) = self.rows[self.index], self.cols[self.index]
        b, s = self._shape()
        blk = t.reshape((b, s) + tuple(t.shape[1:]))[r0:r1, lo:hi]
        return blk.reshape((-1,) + tuple(t.shape[1:]))


class _GatherGrid(torch.autograd.Function):
    """``GridSplit.gather`` with its backward: the ranks' blocks placed as
    tiles of the grid (a few ops whatever the group's size)."""

    @staticmethod
    def forward(ctx, t, grid):
        ctx.grid = grid
        rest = tuple(t.shape[1:])
        order, _, cols, width = grid._tiles(t.device)
        (r0, r1), n_seq = grid.rows[grid.index], grid.n_seq
        blk = _pad_dim(t.reshape((r1 - r0, -1) + rest), 1, width)
        parts = grid.all_gather(blk.contiguous())
        tiles = torch.stack([parts[r] for r in order])   # (nb * ns, R, W)
        b, _ = grid._shape()
        x = tiles.unflatten(0, (-1, n_seq)).transpose(1, 2).reshape(
            (b, n_seq * width) + rest)
        return x.index_select(1, cols).reshape((-1,) + rest)

    @staticmethod
    def backward(ctx, g):
        grid = ctx.grid
        rest = tuple(g.shape[1:])
        _, place, cols, width = grid._tiles(g.device)
        (r0, r1), n_seq = grid.rows[grid.index], grid.n_seq
        b, s = grid._shape()
        padded = g.new_zeros((b, n_seq * width) + rest).index_copy(
            1, cols, g.reshape((b, s) + rest))
        tiles = padded.unflatten(1, (n_seq, width)).unflatten(
            0, (-1, r1 - r0)).transpose(1, 2).reshape(
            (-1, r1 - r0, width) + rest)
        mine = grid.reduce_scatter(tiles.index_select(0, place))
        lo, hi = grid.cols[grid.index]
        return mine[:, :hi - lo].reshape((-1,) + rest), None


@dataclasses.dataclass(frozen=True)
class LossSplit:
    """A worker's (micro)batch loss split over its ``n`` ranks:
    ``all_reduce(t)`` sums ``t`` over them (forward only). A term every
    rank computes whole (an MoE's ``lb_loss`` over the gathered routing)
    enters each rank's loss divided by ``n``."""
    n: int
    all_reduce: Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Hint:
    batch: BatchSplit | GridSplit | None = None
    seq: SeqSplit | None = None
    loss: LossSplit | None = None


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


def batch_split() -> BatchSplit | GridSplit | None:
    """The active batch (or token grid) split, if any."""
    return None if _HINT is None else _HINT.batch


def seq_split() -> SeqSplit | None:
    """The active sequence split, if any."""
    return None if _HINT is None else _HINT.seq


def loss_split() -> LossSplit | None:
    """The active loss split, if any."""
    return None if _HINT is None else _HINT.loss
