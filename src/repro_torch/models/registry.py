"""Model registry (port of ``repro.models.registry``): a family-uniform
interface over the model zoo. The port has the dense family so far:

  * ``init(seed) -> params``
  * ``init_cache(batch_size, shape) -> cache``
  * ``prefill(params, batch, cache) -> (logits, cache)``
  * ``decode(params, token, cache) -> (logits, cache)``

Every ``ModelDef`` is bound to one device; caches are written in place.
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
    init_cache: Callable[..., Any]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode: Callable[..., tuple[torch.Tensor, Any]]


def _lm_def(cfg: ArchConfig, device: torch.device) -> ModelDef:
    def init(seed: int):
        gen = torch.Generator(device=device).manual_seed(seed)
        return transformer.init_lm(cfg, gen, device=device)

    def init_cache(batch_size, shape: ShapeConfig):
        return transformer.init_cache(cfg, batch_size, shape.seq_len,
                                      device=device)

    def prefill(params, batch, cache):
        return transformer.prefill(cfg, params, batch["tokens"], cache,
                                   prompt_len=batch.get("prompt_len"))

    def decode(params, token, cache):
        return transformer.decode_step(cfg, params, token, cache)

    return ModelDef(cfg, device, init, init_cache, prefill, decode)


def get_model(cfg: ArchConfig, device="cuda") -> ModelDef:
    device = torch.device(device)
    if cfg.family == "dense" and cfg.moe is None:
        return _lm_def(cfg, device)
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: the port "
        "has the dense family only; MoE, VLM, SSM, hybrid and enc-dec "
        "come in a later slice")
