"""DiLoCo outer optimization (port of ``repro.core.diloco``; INTELLECT-1
§2.1, Alg. 1), the stacked single-process path.

Each worker runs H inner AdamW steps, then all workers reduce their
pseudo-gradients ``delta_i = anchor - theta_i`` through the int8 ring
and apply one shared Nesterov outer step:

    delta = (1/sum w) * sum_i  w_i (anchor - theta_i)      (elastic weights)
    anchor' = NesterovSGD(anchor, delta)
    theta_i <- anchor'                                      (all workers)

The anchor lives as a flat fp32 buffer (``OuterState.anchor_flat``); the
anchor and momentum trees are views into flat buffers (``SyncEngine.
unflatten``), so the port holds each once where the JAX package holds a
tree and a flat copy. The flat (anchor, theta) pair feeds the ring's
fused first-hop transmit. No function here writes into an anchor,
momentum or residual buffer: each outer step makes new ones, so a
handle that keeps the anchor of its boundary keeps it unchanged.

Three ways to run the outer step:
  * ``outer_sync`` — one worker's (one rank's) step: its own flat
    pseudo-gradient through ``ring_reduce.ring_all_reduce`` over the
    DiLoCo process group (the FSDP-sharded sync of ``train/step.py``'s
    ``build_outer_sync`` runs it on each rank's shard);
  * ``outer_sync_sim`` — stage, reduce and apply in one call;
  * ``begin_outer_sync_sim`` / ``finish_outer_sync_sim`` — the
    overlapped outer sync: the begin stages the pseudo-gradients as a
    hop-steppable ``RingSyncOp`` inside an ``OuterSyncHandle``, the
    trainer dispatches its hops between inner-phase chunks, and the
    finish applies the reduced result one phase late;
    ``resync_outer_sim`` re-reduces the retained rows after a torn or a
    sanitized sync.

Error feedback adds each worker's residual of the last quantization to
its pseudo-gradient (``core/compression.py``); under the delayed overlap
the residual has one slot per interleaved anchor lineage.

The distributed backend (``train/step.py``'s ``DistSyncBackend``) stages
the same pseudo-gradients (``_sim_pseudograds``) into a ring of rank
processes and returns the same ``OuterSyncHandle``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import torch

from repro_torch import spans
from repro_torch.core import compression
from repro_torch.core.ring_reduce import (RingConfig, RingSyncOp,
                                          ring_all_reduce, ring_wire_bytes)
from repro_torch.core.sync_engine import SyncEngine, leaves, tree_map
from repro_torch.kernels import ops as qops
from repro_torch.optim.nesterov import NesterovSGD, NesterovState


class SyncAbortedError(RuntimeError):
    """An in-flight outer sync was aborted (trainer teardown or a
    rejected/discarded reduction); its result must never be applied."""


@dataclasses.dataclass(frozen=True)
class DiLoCoConfig:
    inner_steps: int = 100          # H (paper: 100)
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    quant: str = "int8"             # 'int8' | 'fp32' | 'int4'
    sync_buckets: int = 1           # sub-buckets per ring chunk-hop
    fused_sync: bool = True         # fused tx/rx kernels in the ring
    # 'none'    — synchronous outer step (the ring is a barrier between
    #             inner phases);
    # 'delayed' — the ring runs UNDER the next inner phase (hops
    #             dispatched between inner-phase chunks) and the reduced
    #             pseudo-gradient is applied one phase late (§2.2)
    overlap: str = "none"
    error_feedback: bool = False
    # hierarchical reduce (paper's ElasticDeviceMesh split): each rank
    # rings only its intra-node slice over the WAN (DiLoCo) axis and the
    # full vector is rebuilt intra-node — per-rank WAN bytes / n_local.
    # Distributed backend only (train.step.DistSyncBackend); codebooks
    # become per-slice, so results are bit-identical to the PER-SLICE
    # simulator rather than the flat one (tested).
    hierarchical: bool = False

    @property
    def ring(self) -> RingConfig:
        return RingConfig(quant=self.quant, buckets=self.sync_buckets,
                          fused=self.fused_sync)

    @property
    def outer_opt(self) -> NesterovSGD:
        return NesterovSGD(lr=self.outer_lr, momentum=self.outer_momentum)


class OuterState(NamedTuple):
    anchor: Any                # fp32 tree: views into anchor_flat
    opt: NesterovState         # fp32 outer momentum (views of one buffer)
    residual: torch.Tensor     # fp32 EF residual ((k, 0) when EF is off)
    outer_step: int
    anchor_flat: torch.Tensor | None = None   # flat fp32 anchor


def init_outer_state(params, cfg: DiLoCoConfig) -> OuterState:
    eng = SyncEngine.for_tree(params)
    a_flat = eng.flatten(params)
    m_flat = torch.zeros_like(a_flat)
    n = eng.numel if cfg.error_feedback else 0
    # two-slot residual under the delayed overlap: one per interleaved
    # anchor lineage (see finish_outer_sync_sim)
    shape = (2, n) if cfg.error_feedback and cfg.overlap == "delayed" \
        else (n,)
    f32 = torch.float32
    return OuterState(eng.unflatten(a_flat, dtype=f32),
                      NesterovState(eng.unflatten(m_flat, dtype=f32)),
                      torch.zeros(shape, dtype=f32, device=a_flat.device),
                      0, a_flat)


def init_outer_state_sim(params_one_worker, cfg: DiLoCoConfig,
                         k: int) -> OuterState:
    """Outer state of the stacked simulator: one shared anchor and
    momentum, per-worker EF residuals ((2, k, n) under the delayed
    overlap, one slot per interleaved lineage)."""
    st = init_outer_state(params_one_worker, cfg)
    shape = st.residual.shape[:-1] + (k, st.residual.shape[-1])
    return st._replace(residual=torch.zeros(
        shape, dtype=torch.float32, device=st.residual.device))


def _ef_roundtrip(pgs: torch.Tensor, cfg: DiLoCoConfig) -> torch.Tensor:
    """Row-wise quantize/dequantize roundtrip used by error feedback
    (int8 through the codec wrappers, int4 plain)."""
    if cfg.quant == "int8":
        return qops.dequantize(qops.quantize(pgs))
    return compression.dequantize4(compression.quantize4(pgs),
                                   pgs.shape[-1])


def _rows_dtype(stacked_params) -> torch.dtype:
    """The parameters' one dtype, else fp32: the dtype the retained
    theta rows keep (the encode widens them to fp32 exactly)."""
    dtypes = {l.dtype for l in leaves(stacked_params)}
    return dtypes.pop() if len(dtypes) == 1 else torch.float32


def _sim_pseudograds(stacked_params, state: OuterState,
                     cfg: DiLoCoConfig, ef_slot: int = 0):
    """Stacked flat pseudo-gradients (+EF rewrite) off the flat anchor.
    Returns (k, any_params, a_flat, pgs, new_residuals, fused_src).

    With a two-slot residual ((2, k, n): EF + delayed overlap) only slot
    ``ef_slot`` is read, and ``new_residuals`` is that slot's (k, n)
    replacement, committed by :func:`_commit_residual`. Every tensor
    returned is new or an unwritten buffer of ``state``: none aliases
    the parameters, which the trainer writes in place."""
    k = leaves(stacked_params)[0].shape[0]
    any_params = tree_map(lambda p: p[0], stacked_params)
    eng = SyncEngine.for_tree(any_params)
    a_flat = (state.anchor_flat if state.anchor_flat is not None
              else eng.flatten(state.anchor))
    thetas = eng.flatten_rows(stacked_params,
                              dtype=_rows_dtype(stacked_params))
    fused_src = (a_flat, thetas) if _fused_src_ok(cfg) else None
    pgs = a_flat[None, :] - thetas           # fp32: widening is exact
    del thetas                               # only fused_src keeps it
    new_residuals = state.residual
    if cfg.error_feedback:
        # in place on the fresh pgs buffer: the same bits, two (k, n)
        # fp32 buffers fewer at the peak
        res = state.residual[ef_slot] if state.residual.dim() == 3 \
            else state.residual
        pgs.add_(res)
        deqs = _ef_roundtrip(pgs, cfg)
        new_residuals = pgs.sub_(deqs)
        pgs = deqs
    return k, any_params, a_flat, pgs, new_residuals, fused_src


def _commit_residual(state: OuterState, new_residuals, ef_slot: int):
    """Merge a boundary's EF residual into the state's buffer. In
    two-slot mode only the boundary's OWN slot is written, against the
    buffer as it stands at commit time (a copy of it: the old state's
    buffer is never written), so an interleaved commit of the other
    lineage is never clobbered."""
    if state.residual.dim() == 3:
        res = state.residual.clone()
        res[ef_slot] = new_residuals
        return res
    return new_residuals


def _apply_outer(reduced_pg_flat, params, state: OuterState,
                 cfg: DiLoCoConfig, new_residual, a_flat):
    """Flat-space outer Nesterov step; the new anchor and momentum trees
    are views of the new flat buffers, the new params a cast of them."""
    with spans.span("outer.apply", a_flat.device):
        eng = SyncEngine.for_tree(state.anchor)
        m_flat = eng.flatten(state.opt.momentum)
        new_a_flat, new_m_flat = cfg.outer_opt.update_flat(
            reduced_pg_flat, m_flat, a_flat)
        new_params = eng.unflatten(new_a_flat, like=params)
    f32 = torch.float32
    return new_params, OuterState(
        eng.unflatten(new_a_flat, dtype=f32),
        NesterovState(eng.unflatten(new_m_flat, dtype=f32)),
        new_residual, state.outer_step + 1, new_a_flat)


def _fused_src_ok(cfg: DiLoCoConfig) -> bool:
    """The fused first-hop transmit sends quantize(w*(anchor-theta))
    straight off the model buffers: valid when the wire payload is the
    raw pseudo-gradient and the ring is int8."""
    return cfg.fused_sync and cfg.quant == "int8" and \
        not cfg.error_feedback


# -- one worker's outer step over a process group ----------------------------


def _pseudograd(params, state: OuterState, cfg: DiLoCoConfig):
    """One worker's flat fp32 pseudo-gradient (+EF residual) off the
    flat anchor. Returns (pg, new_residual, theta_flat, anchor_flat).
    With a two-slot residual ((2, n): EF under the delayed overlap on
    this synchronous path) the slot is ``outer_step % 2``."""
    eng = SyncEngine.for_tree(params)
    p_flat = eng.flatten(params)
    a_flat = (state.anchor_flat if state.anchor_flat is not None
              else eng.flatten(state.anchor))
    pg = a_flat - p_flat
    new_residual = state.residual
    if cfg.error_feedback:
        two_slot = state.residual.dim() == 2
        slot = state.outer_step % 2
        pg = pg + (state.residual[slot] if two_slot else state.residual)
        deq = _ef_roundtrip(pg[None], cfg)[0]
        if two_slot:
            new_residual = state.residual.clone()
            new_residual[slot] = pg - deq
        else:
            new_residual = pg - deq
        pg = deq
    return pg, new_residual, p_flat, a_flat


def outer_sync(params, state: OuterState, cfg: DiLoCoConfig, group,
               ring_order: Sequence[int] | None = None,
               weight: torch.Tensor | None = None):
    """One DiLoCo outer step for this worker: its pseudo-gradient through
    the ring over ``group`` (the DiLoCo process group), then the shared
    Nesterov step. Returns (params', state'); the new anchor and
    momentum trees are views of the new flat buffers."""
    pg, new_residual, p_flat, a_flat = _pseudograd(params, state, cfg)
    fused_src = (a_flat, p_flat) if _fused_src_ok(cfg) else None
    reduced = ring_all_reduce(pg, group, ring_order=ring_order,
                              cfg=cfg.ring, weight=weight,
                              fused_src=fused_src)
    del pg, p_flat, fused_src
    return _apply_outer(reduced, params, state, cfg, new_residual, a_flat)


def outer_sync_sim(stacked_params, state: OuterState, cfg: DiLoCoConfig,
                   ring_order: Sequence[int] | None = None,
                   weights: torch.Tensor | None = None,
                   ef_slot: int = 0):
    """One outer step over stacked (k, ...) worker params with a shared
    outer state. Returns (stacked new params, new state); the stacked
    params are ``expand`` views of one copy (every worker resets to the
    same anchor), so a caller that writes into them copies first."""
    h = begin_outer_sync_sim(stacked_params, state, cfg, ring_order,
                             weights, ef_slot)
    return finish_outer_sync_sim(h, stacked_params, state)


# -- overlapped outer sync (begin / finish pair) ------------------------------


class OuterSyncHandle:
    """One boundary's outer sync in flight.

    Made by :func:`begin_outer_sync_sim`: the pseudo-gradients are
    staged in a ``RingSyncOp``; the trainer dispatches its hops between
    inner-phase chunks (``step()``) and :func:`finish_outer_sync_sim`
    applies the result one phase late. ``overlap="none"`` is begin and
    finish back to back, which is :func:`outer_sync_sim`.

    The handle keeps the anchor snapshot its pseudo-gradients are rooted
    at (``a_flat``), the staged rows (``op.xs``) and the fused source
    ``(a_flat, thetas)``. None of them aliases the trainer's parameters
    or optimizer state, which the next inner phase writes in place.
    """

    def __init__(self, op: RingSyncOp, cfg: DiLoCoConfig, a_flat,
                 new_residuals, weights, k: int, ef_slot: int = 0):
        self.op = op
        self.cfg = cfg
        self.a_flat = a_flat
        # EF residual made at begin; two-slot mode: the (k, n)
        # replacement of slot ``ef_slot`` only (see _commit_residual)
        self.new_residuals = new_residuals
        self.ef_slot = ef_slot
        self.weights = weights
        self.k = k
        self.aborted = False

    def step(self) -> bool:
        """Dispatch the next ring hop; True iff one was dispatched."""
        if self.aborted:
            return False
        return self.op.step()

    @property
    def hops_total(self) -> int:
        return 0 if self.aborted else self.op.hops_total

    @property
    def hops_done(self) -> int:
        return 0 if self.aborted else self.op.hops_done

    def abort(self) -> None:
        """Discard this boundary's sync: drop the staged accumulators
        and retained inputs so nothing can be applied. Further
        ``finish``/``resync`` raises :class:`SyncAbortedError`. An op
        with ranks behind it (``train.step.DistRingSyncOp``) is closed
        first, so the ranks forget it."""
        if hasattr(self.op, "close"):
            self.op.close()
        self.aborted = True
        self.op = None

    def norm_sideband(self):
        """(k, k * buckets) per-chunk norm sideband of the retained
        pseudo-gradient rows (admission layer / localization)."""
        if self.aborted:
            raise SyncAbortedError("norm_sideband on an aborted sync")
        return self.op.norm_sideband()

    def sanitize(self, slots) -> None:
        """Zero the retained rows of ``slots`` in place so a later
        ``restart`` re-reduces only clean contributions.

        Zero-weighting a corrupted row is not enough (``NaN * 0 ==
        NaN``), and the staged accumulators saw the raw rows: after
        sanitizing, the caller RESTARTS the reduction with those slots'
        weights at zero, never finishes it. A sanitized theta row gets
        the anchor (in the rows' dtype), so its fused transmit reads a
        finite row, which its zero weight zeroes."""
        if self.aborted:
            raise SyncAbortedError("sanitize on an aborted sync")
        if not slots:
            return
        idx = sorted(slots)
        op = self.op
        op.xs[idx] = 0.0
        if op.fused_src is not None:
            a_flat, thetas = op.fused_src
            thetas[idx] = a_flat.to(thetas.dtype)
        if self.cfg.error_feedback:
            # the EF rewrite folded the corrupted rows into the new
            # residuals, which would re-inject them at the next boundary
            self.new_residuals = self.new_residuals.clone()
            self.new_residuals[idx] = 0.0


def begin_outer_sync_sim(stacked_params, state: OuterState,
                         cfg: DiLoCoConfig,
                         ring_order: Sequence[int] | None = None,
                         weights: torch.Tensor | None = None,
                         ef_slot: int = 0) -> OuterSyncHandle:
    """Boundary front half: stage the pseudo-gradients as a steppable
    ring op. Nothing is reduced or applied yet.

    ``ef_slot`` (two-slot EF under the delayed overlap): the residual
    lineage of this boundary; the trainer alternates 0/1 per begin."""
    k, _, a_flat, pgs, new_residuals, fused_src = _sim_pseudograds(
        stacked_params, state, cfg, ef_slot=ef_slot)
    if weights is None:
        weights = torch.ones((k,), dtype=torch.float32, device=pgs.device)
    op = RingSyncOp(pgs, ring_order=ring_order, cfg=cfg.ring,
                    weights=weights, fused_src=fused_src)
    return OuterSyncHandle(op, cfg, a_flat, new_residuals, weights, k,
                           ef_slot=ef_slot)


def _finish_apply(handle: OuterSyncHandle, reduced, stacked_params,
                  state: OuterState):
    if handle.aborted:
        raise SyncAbortedError("apply on an aborted sync")
    any_params = tree_map(lambda p: p[0], stacked_params)
    res = _commit_residual(state, handle.new_residuals, handle.ef_slot)
    new_params, new_state = _apply_outer(
        reduced[0], any_params, state._replace(residual=res),
        handle.cfg, res, handle.a_flat)
    k = handle.k
    return tree_map(lambda p: p[None].expand((k,) + tuple(p.shape)),
                    new_params), new_state


def finish_outer_sync_sim(handle: OuterSyncHandle, stacked_params,
                          state: OuterState):
    """Drain the remaining hops and apply the reduced pseudo-gradient to
    the anchor SNAPSHOT it was computed against (the handle's
    ``a_flat``), then reset every worker to the new tip.

    Deliberately not "apply to the current anchor": under the trainer's
    boundary order (begin new, then finish old) the anchor at finish has
    already absorbed the previous boundary's delta, so tip t is
    ``T_t = Nesterov(T_{t-2}, Delta_{t-1})``: two interleaved lineages,
    each advanced by the synchronous DiLoCo rule, the shared outer
    momentum threading through every apply (the reference's docstring
    gives the measurement behind the choice)."""
    if handle.aborted:
        raise SyncAbortedError("finish on an aborted sync")
    return _finish_apply(handle, handle.op.finish(), stacked_params,
                         state)


def resync_outer_sim(handle: OuterSyncHandle, stacked_params,
                     state: OuterState, weights: torch.Tensor):
    """Torn-overlap fallback: re-reduce the RETAINED pseudo-gradients
    over the survivors (``weights`` with the dead workers zeroed) and
    apply; every survivor derives the identical result from identical
    retained inputs."""
    if handle.aborted:
        raise SyncAbortedError("resync on an aborted sync")
    return _finish_apply(handle, handle.op.restart(weights),
                         stacked_params, state)


def sync_wire_bytes(params, n_workers: int, cfg: DiLoCoConfig) -> int:
    """Per-worker wire bytes of ONE outer sync."""
    n = sum(l.numel() for l in leaves(params))
    return ring_wire_bytes(n, n_workers, cfg.quant,
                           buckets=cfg.sync_buckets)


def bandwidth_reduction_factor(cfg: DiLoCoConfig,
                               dp_bytes_per_step: float = 4.0) -> float:
    """Communication-volume reduction vs per-step fp32 data-parallel
    (paper: 400x at H=100/int8)."""
    bytes_per_elem = {"int8": 1.0, "int4": 0.5, "fp32": 4.0}[cfg.quant]
    return cfg.inner_steps * dp_bytes_per_step / bytes_per_elem
