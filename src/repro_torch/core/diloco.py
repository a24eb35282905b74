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
fused first-hop transmit.

Not ported yet: the distributed ``outer_sync`` (shard_map), the
overlapped begin/finish/resync handles, error feedback and int4
(``core/compression.py``); asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core.ring_reduce import (RingConfig, ring_wire_bytes,
                                          simulate_ring_all_reduce)
from repro_torch.core.sync_engine import SyncEngine, leaves, tree_map
from repro_torch.optim.nesterov import NesterovSGD, NesterovState


@dataclasses.dataclass(frozen=True)
class DiLoCoConfig:
    inner_steps: int = 100          # H (paper: 100)
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    quant: str = "int8"             # 'int8' | 'fp32'
    sync_buckets: int = 1           # sub-buckets per ring chunk-hop
    fused_sync: bool = True         # fused tx/rx kernels in the ring
    overlap: str = "none"           # only the synchronous outer step
    error_feedback: bool = False

    def __post_init__(self):
        if self.quant not in ("int8", "fp32"):
            raise NotImplementedError(
                f"quant {self.quant!r} is not ported yet (int4 comes with "
                "core/compression.py in a later slice)")
        if self.error_feedback:
            raise NotImplementedError("error feedback is not ported yet")
        if self.overlap != "none":
            raise NotImplementedError(
                f"overlap {self.overlap!r} is not ported yet: the port "
                "runs the synchronous outer step")

    @property
    def ring(self) -> RingConfig:
        return RingConfig(quant=self.quant, buckets=self.sync_buckets,
                          fused=self.fused_sync)

    @property
    def outer_opt(self) -> NesterovSGD:
        return NesterovSGD(lr=self.outer_lr, momentum=self.outer_momentum)


class OuterState(NamedTuple):
    """The reference's fields except the error-feedback residual, which
    comes with error feedback."""
    anchor: Any                # fp32 tree: views into anchor_flat
    opt: NesterovState         # fp32 outer momentum (views of one buffer)
    outer_step: int
    anchor_flat: torch.Tensor | None = None   # flat fp32 anchor


def init_outer_state(params, cfg: DiLoCoConfig) -> OuterState:
    eng = SyncEngine.for_tree(params)
    a_flat = eng.flatten(params)
    m_flat = torch.zeros_like(a_flat)
    f32 = torch.float32
    return OuterState(eng.unflatten(a_flat, dtype=f32),
                      NesterovState(eng.unflatten(m_flat, dtype=f32)),
                      0, a_flat)


def init_outer_state_sim(params_one_worker, cfg: DiLoCoConfig,
                         k: int) -> OuterState:
    """Outer state of the stacked simulator: one shared anchor and
    momentum (the reference adds per-worker error-feedback residuals)."""
    return init_outer_state(params_one_worker, cfg)


def _sim_pseudograds(stacked_params, state: OuterState,
                     cfg: DiLoCoConfig):
    """Stacked flat pseudo-gradients off the flat anchor. Returns
    (k, any_params, a_flat, pgs, fused_src)."""
    k = leaves(stacked_params)[0].shape[0]
    any_params = tree_map(lambda p: p[0], stacked_params)
    eng = SyncEngine.for_tree(any_params)
    a_flat = (state.anchor_flat if state.anchor_flat is not None
              else eng.flatten(state.anchor))
    p_flats = eng.flatten_rows(stacked_params)
    pgs = a_flat[None, :] - p_flats
    fused_src = (a_flat, p_flats) if _fused_src_ok(cfg) else None
    return k, any_params, a_flat, pgs, fused_src


def _apply_outer(reduced_pg_flat, params, state: OuterState,
                 cfg: DiLoCoConfig, a_flat):
    """Flat-space outer Nesterov step; the new anchor and momentum trees
    are views of the new flat buffers, the new params a cast of them."""
    eng = SyncEngine.for_tree(state.anchor)
    m_flat = eng.flatten(state.opt.momentum)
    new_a_flat, new_m_flat = cfg.outer_opt.update_flat(
        reduced_pg_flat, m_flat, a_flat)
    f32 = torch.float32
    new_params = eng.unflatten(new_a_flat, like=params)
    return new_params, OuterState(
        eng.unflatten(new_a_flat, dtype=f32),
        NesterovState(eng.unflatten(new_m_flat, dtype=f32)),
        state.outer_step + 1, new_a_flat)


def _fused_src_ok(cfg: DiLoCoConfig) -> bool:
    """The fused first-hop transmit sends quantize(w*(anchor-theta))
    straight off the model buffers: valid when the wire payload is the
    raw pseudo-gradient and the ring is int8."""
    return cfg.fused_sync and cfg.quant == "int8" and \
        not cfg.error_feedback


def outer_sync_sim(stacked_params, state: OuterState, cfg: DiLoCoConfig,
                   ring_order: Sequence[int] | None = None,
                   weights: torch.Tensor | None = None):
    """One outer step over stacked (k, ...) worker params with a shared
    outer state. Returns (stacked new params, new state); the stacked
    params are ``expand`` views of one copy (every worker resets to the
    same anchor), so a caller that writes into them copies first."""
    k, any_params, a_flat, pgs, fused_src = _sim_pseudograds(
        stacked_params, state, cfg)
    reduced = simulate_ring_all_reduce(pgs, ring_order=ring_order,
                                       cfg=cfg.ring, weights=weights,
                                       fused_src=fused_src)
    del pgs, fused_src
    # every worker's reduced copy is identical -> apply outer once
    new_params, new_state = _apply_outer(reduced[0], any_params, state,
                                         cfg, a_flat)
    stacked_new = tree_map(lambda p: p[None].expand((k,) + tuple(p.shape)),
                           new_params)
    return stacked_new, new_state


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
