"""Model registry (port of ``repro.models.registry``): a family-uniform
interface over the model zoo. The port has the transformer families
(dense, MoE, VLM) so far:

  * ``init(seed) -> params``
  * ``loss(params, batch) -> (loss, metrics)`` (differentiable)
  * ``init_cache(batch_size, shape) -> cache``
  * ``prefill(params, batch, cache) -> (logits, cache)``
  * ``decode(params, token, cache) -> (logits, cache)``
  * ``prefill_extend(params, batch, cache) -> (logits, cache)``: one
    chunked-prefill segment (batch keys ``tokens``, ``start``,
    ``seg_len``); None for sliding-window models

and the pipeline-stage partition of swarm serving (``make_stages``,
``stage_param_specs``). Every ``ModelDef`` and ``StageDef`` is bound to
one device; caches are written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelDef:
    cfg: ArchConfig
    device: torch.device
    init: Callable[[int], Any]
    loss: Callable[..., tuple[torch.Tensor, dict]]
    init_cache: Callable[..., Any]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode: Callable[..., tuple[torch.Tensor, Any]]
    prefill_extend: Callable[..., tuple[torch.Tensor, Any]] | None = None


def _lm_def(cfg: ArchConfig, device: torch.device) -> ModelDef:
    def init(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        return transformer.init_lm(cfg, gen, device=device)

    def loss(params, batch):
        return transformer.loss_fn(cfg, params, batch)

    def init_cache(batch_size, shape: ShapeConfig, device=device):
        # device="meta": the abstract cache (paging sizes its pool from it)
        return transformer.init_cache(cfg, batch_size, shape.seq_len,
                                      device=device)

    def prefill(params, batch, cache):
        return transformer.prefill(cfg, params, batch["tokens"], cache,
                                   prompt_len=batch.get("prompt_len"),
                                   frontend=batch.get("frontend"))

    def decode(params, token, cache):
        return transformer.decode_step(cfg, params, token, cache)

    def prefill_extend(params, batch, cache):
        return transformer.prefill_extend(
            cfg, params, batch["tokens"], cache, start=batch["start"],
            seg_len=batch["seg_len"])

    return ModelDef(cfg, device, init, loss, init_cache, prefill, decode,
                    prefill_extend=(None if cfg.sliding_window
                                    else prefill_extend))


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
            "port has the dense, MoE and VLM families; SSM and hybrid "
            "come in a later slice, then enc-dec")


def get_model(cfg: ArchConfig, device="cuda") -> ModelDef:
    _check_ported(cfg)
    return _lm_def(cfg, torch.device(device))


# -- pipeline-stage partition (swarm serving) ---------------------------------


@dataclasses.dataclass(frozen=True)
class StageDef:
    """One contiguous-layer pipeline stage of a decoder-only LM.

    A stage owns layers ``[lo, hi)`` of the stack; the first stage also
    owns the embedding and any dense-prefix layers (``dense{i}``, with
    their caches), the last the final norm and LM head.
    ``slice_params`` takes the stage's parameter subtree (views) from
    the full tree; ``init_cache(batch_size, max_len)`` allocates the
    stage-local KV cache on the device ``make_stages`` was given (or
    ``device=``);
    ``prefill`` / ``decode`` run the stage forward (tokens in / logits
    out at the chain's ends, (B, S, D) activations in between; the
    first stage's ``prefill`` also takes a VLM's ``frontend``).
    Composing every stage in order is bitwise the monolithic
    ``ModelDef.prefill`` / ``decode``: both are the same
    ``stage_prefill`` / ``stage_decode``."""
    cfg: ArchConfig
    index: int
    n_stages: int
    lo: int
    hi: int
    slice_params: Callable[[Any], Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode: Callable[..., tuple[torch.Tensor, Any]]

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.n_stages - 1


def make_stages(cfg: ArchConfig, k_stages: int,
                device="cuda") -> list[StageDef]:
    """Partition a decoder-only model into ``k_stages`` pipeline stages.
    Only the transformer families (dense / moe / vlm) have the stage
    seam: the others raise ``ValueError``, as in the JAX package."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(
            f"stage partition unsupported for family {cfg.family!r} "
            "(only dense/moe/vlm)")
    _check_ported(cfg)
    device = torch.device(device)
    stages = []
    for i, (lo, hi) in enumerate(transformer.stage_bounds(cfg, k_stages)):
        first, last = i == 0, i == k_stages - 1

        def slice_params(params, lo=lo, hi=hi, first=first, last=last):
            return transformer.slice_stage_params(
                cfg, params, lo, hi, first=first, last=last)

        def init_cache(batch_size, max_len, lo=lo, hi=hi, first=first,
                       device=device):
            # device="meta": the abstract cache (a paged pool's template)
            return transformer.init_stage_cache(cfg, batch_size, max_len,
                                                lo, hi, first=first,
                                                device=device)

        def prefill(params, inp, cache, prompt_len=None, frontend=None,
                    first=first, last=last):
            return transformer.stage_prefill(
                cfg, params, inp, cache, first=first, last=last,
                prompt_len=prompt_len, frontend=frontend)

        def decode(params, inp, cache, first=first, last=last):
            return transformer.stage_decode(
                cfg, params, inp, cache, first=first, last=last)

        stages.append(StageDef(cfg, i, k_stages, lo, hi, slice_params,
                               init_cache, prefill, decode))
    return stages


def stage_param_specs(cfg: ArchConfig, k_stages: int) -> list:
    """The abstract parameter tree of each stage (``meta``-device
    tensors: shapes and dtypes, no storage), the ``like`` for restoring
    published stage weights without materializing the full model."""
    specs = transformer.alloc_lm(cfg, device="meta")
    return [s.slice_params(specs)
            for s in make_stages(cfg, k_stages, device="meta")]
