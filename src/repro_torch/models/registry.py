"""Model registry (port of ``repro.models.registry``): a family-uniform
interface over the model zoo (the transformer families dense, MoE and
VLM, the SSM and hybrid families and the encoder-decoder):

  * ``init(seed) -> params``
  * ``axes() -> tree of tuples``: each parameter's logical axis names,
    the reference's ``eval_axes(init)`` tree (``sharding.partition``
    maps them to layouts); ``param_shapes()`` the abstract parameter
    tree (``meta`` tensors)
  * ``loss(params, batch, remat=False, fetch=None) -> (loss, metrics)``
    (differentiable; ``remat`` checkpoints each layer, ``fetch`` maps
    each layer's weights before use: ``common.run_layer``)
  * ``input_specs(shape) -> batch of meta tensors``: the reference's
    input shapes and dtypes of a shape cell (the dry run)
  * ``init_cache(batch_size, shape) -> cache``
  * ``prefill(params, batch, cache, fetch=None) -> (logits, cache)``
  * ``decode(params, token, cache, fetch=None) -> (logits, cache)``
    (``fetch`` maps each layer's weights before use, as the loss's)
  * ``cache_pspecs(cache_shapes, plan, mesh_axes)``: the layout of
    every leaf of a cache tree (``sharding.partition.cache_pspecs``)
  * ``prefill_extend(params, batch, cache) -> (logits, cache)``: one
    chunked-prefill segment (batch keys ``tokens``, ``start``,
    ``seg_len``); None for sliding-window models, for the SSM and
    hybrid families (a state fold has no resume offset) and for enc-dec
  * ``logits(params, tokens) -> (B, S, V)``: the bare training-mode
    forward, for losses that need per-token log-probs (the RL tier's
    GRPO loss); None for enc-dec, whose forward needs more than tokens

and the pipeline-stage partition of swarm serving (``make_stages``,
``stage_param_specs``). Every ``ModelDef`` and ``StageDef`` is bound to
one device; caches are written in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, transformer

# enc-dec decode shapes: one decoder token, cross-attention K/V over a
# source of seq_len frames, and a modest self cache (the generated side)
ENCDEC_SELF_CACHE = 4096


@dataclasses.dataclass(frozen=True)
class ModelDef:
    cfg: ArchConfig
    device: torch.device
    init: Callable[[int], Any]
    loss: Callable[..., tuple[torch.Tensor, dict]]
    init_cache: Callable[..., Any]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode: Callable[..., tuple[torch.Tensor, Any]]
    axes: Callable[[], Any]
    param_shapes: Callable[[], Any]
    input_specs: Callable[[ShapeConfig], dict]
    prefill_extend: Callable[..., tuple[torch.Tensor, Any]] | None = None
    logits: Callable[..., torch.Tensor] | None = None

    def cache_pspecs(self, cache_shapes, plan, mesh_axes):
        """Spec tree of a cache tree (path-aware: KV caches shard
        batch and heads, or the sequence when the heads do not divide
        'model'; SSM states batch and heads, conv rings batch and
        channels; lengths replicate), the reference's rules
        (``partition.cache_leaf_pspec``)."""
        from repro_torch.sharding import partition
        return partition.cache_pspecs(cache_shapes, plan, mesh_axes)


def _meta(dtype, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _lm_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Decoder-only inputs; a VLM's F frontend positions come out of the
    token count (``repro.models.registry._lm_input_specs``)."""
    b, s, nf = shape.global_batch, shape.seq_len, cfg.n_frontend
    i32 = torch.int32
    if shape.kind == "decode":
        return {"token": _meta(i32, b, 1)}
    specs = {"tokens": _meta(i32, b, s - nf)}
    if shape.kind == "train":
        specs["targets"] = _meta(i32, b, s - nf)
        specs["mask"] = _meta(torch.float32, b, s - nf)
    if nf:
        specs["frontend"] = _meta(cfg.torch_dtype, b, nf, cfg.d_model)
    return specs


def _encdec_input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Enc-dec inputs: a train cell splits seq_len between the source
    frames and the target tokens."""
    b, s, i32 = shape.global_batch, shape.seq_len, torch.int32
    if shape.kind == "train":
        half = s // 2
        return {"src_embeds": _meta(cfg.torch_dtype, b, half, cfg.d_model),
                "tokens": _meta(i32, b, half),
                "targets": _meta(i32, b, half),
                "mask": _meta(torch.float32, b, half)}
    if shape.kind == "prefill":
        return {"src_embeds": _meta(cfg.torch_dtype, b, s, cfg.d_model),
                "bos": _meta(i32, b, 1)}
    return {"token": _meta(i32, b, 1)}


def _lm_def(cfg: ArchConfig, device: torch.device) -> ModelDef:
    def init(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        return transformer.init_lm(cfg, gen, device=device)

    def loss(params, batch, remat=False, fetch=None):
        return transformer.loss_fn(cfg, params, batch, remat=remat,
                                   fetch=fetch)

    def init_cache(batch_size, shape: ShapeConfig, device=device):
        # device="meta": the abstract cache (paging sizes its pool from it)
        return transformer.init_cache(cfg, batch_size, shape.seq_len,
                                      device=device)

    def prefill(params, batch, cache, fetch=None):
        return transformer.prefill(cfg, params, batch["tokens"], cache,
                                   prompt_len=batch.get("prompt_len"),
                                   frontend=batch.get("frontend"),
                                   fetch=fetch)

    def decode(params, token, cache, fetch=None):
        return transformer.decode_step(cfg, params, token, cache,
                                       fetch=fetch)

    def prefill_extend(params, batch, cache):
        return transformer.prefill_extend(
            cfg, params, batch["tokens"], cache, start=batch["start"],
            seg_len=batch["seg_len"])

    def logits(params, tokens):
        return transformer.forward(cfg, params, tokens)[0]

    return ModelDef(cfg, device, init, loss, init_cache, prefill, decode,
                    functools.partial(transformer.lm_axes, cfg),
                    functools.partial(transformer.alloc_lm, cfg,
                                      device="meta"),
                    functools.partial(_lm_input_specs, cfg),
                    prefill_extend=(None if cfg.sliding_window
                                    else prefill_extend),
                    logits=logits)


def _encdec_def(cfg: ArchConfig, device: torch.device) -> ModelDef:
    """The encoder-decoder: ``prefill`` takes {"src_embeds", "bos"}; the
    self cache holds min(ENCDEC_SELF_CACHE, seq_len) cells and the cross
    cache seq_len source frames (seq_len // 2 for a ``train`` shape)."""
    def init(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        return encdec.init_encdec(cfg, gen, device=device)

    def loss(params, batch, remat=False, fetch=None):
        return encdec.loss_fn(cfg, params, batch, remat=remat, fetch=fetch)

    def init_cache(batch_size, shape: ShapeConfig, device=device):
        src = shape.seq_len if shape.kind != "train" else shape.seq_len // 2
        return encdec.init_cache(cfg, batch_size,
                                 min(ENCDEC_SELF_CACHE, shape.seq_len), src,
                                 device=device)

    def prefill(params, batch, cache, fetch=None):
        return encdec.prefill(cfg, params, batch["src_embeds"], batch["bos"],
                              cache, fetch=fetch)

    def decode(params, token, cache, fetch=None):
        return encdec.decode_step(cfg, params, token, cache, fetch=fetch)

    return ModelDef(cfg, device, init, loss, init_cache, prefill, decode,
                    functools.partial(encdec.encdec_axes, cfg),
                    functools.partial(encdec.alloc_encdec, cfg,
                                      device="meta"),
                    functools.partial(_encdec_input_specs, cfg))


def _hybrid_def(cfg: ArchConfig, device: torch.device) -> ModelDef:
    """The SSM (``attn_every=None``) and hybrid families."""
    def init(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        return hybrid.init_hybrid(cfg, gen, device=device)

    def loss(params, batch, remat=False, fetch=None):
        return hybrid.loss_fn(cfg, params, batch, remat=remat, fetch=fetch)

    def init_cache(batch_size, shape: ShapeConfig, device=device):
        # the shared attention's cache holds the full context
        return hybrid.init_cache(cfg, batch_size, shape.seq_len,
                                 device=device)

    def prefill(params, batch, cache, fetch=None):
        return hybrid.prefill(cfg, params, batch["tokens"], cache,
                              prompt_len=batch.get("prompt_len"),
                              fetch=fetch)

    def decode(params, token, cache, fetch=None):
        return hybrid.decode_step(cfg, params, token, cache, fetch=fetch)

    def logits(params, tokens):
        return hybrid.forward(cfg, params, tokens)[0]

    return ModelDef(cfg, device, init, loss, init_cache, prefill, decode,
                    functools.partial(hybrid.hybrid_axes, cfg),
                    functools.partial(hybrid.alloc_hybrid, cfg,
                                      device="meta"),
                    functools.partial(_lm_input_specs, cfg),
                    logits=logits)


def get_model(cfg: ArchConfig, device="cuda") -> ModelDef:
    device = torch.device(device)
    if cfg.family in ("dense", "moe", "vlm"):
        return _lm_def(cfg, device)
    if cfg.family == "encdec":
        return _encdec_def(cfg, device)
    if cfg.family in ("ssm", "hybrid"):
        return _hybrid_def(cfg, device)
    raise ValueError(f"unknown family {cfg.family!r}")


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
