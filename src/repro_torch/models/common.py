"""Shared model substrate (port of ``repro.models.common``): the
parameter initializer, RMSNorm, RoPE, SwiGLU, the embedding gather and
the training loss (cross-entropy + max-z).

Parameters are plain nested dicts of tensors with the JAX package's
layout (stacked ``(L, ...)`` layers, ``x @ W`` weight orientation), so
converting ``repro`` weights is a copy. ``repro.sharding.act_hints``'s
``hint_residual`` is a sharding constraint for XLA's partitioner; its
counterpart, ``repro_torch.sharding.act_hints``, tells the few model
functions that depend on the rest of a split batch or sequence (the MoE
routing, a sequence-split prefill) what this rank's part is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def normal_(out: torch.Tensor, generator: torch.Generator, *,
            scale: float | None = None) -> torch.Tensor:
    """Fill ``out`` with normal * scale, drawn in fp32 on ``out``'s
    device and cast to its dtype. The default scale is fan_in ** -0.5
    with fan_in = shape[0] for matrices, as ``ParamBuilder.add`` does;
    pass one layer's slice of a stacked tensor so fan_in is that
    layer's."""
    shape = tuple(out.shape)
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    val = torch.randn(shape, generator=generator, dtype=torch.float32,
                      device=out.device)
    out.copy_(val.mul_(s))
    return out


def stack_layer_axes(axes):
    """Prepend the stacked ``"layers"`` dim to every axis tuple of a
    layer's logical-axes tree (the reference's ``stack_layer_axes``)."""
    if isinstance(axes, dict):
        return {k: stack_layer_axes(v) for k, v in axes.items()}
    return ("layers",) + tuple(axes)


def fetch_top(params: dict, fetch) -> dict:
    """``params`` with its top-level tensors (embedding, final norm,
    head: everything that is not a layer tree) passed through ``fetch``
    as one tree; unchanged when ``fetch`` is None."""
    if fetch is None:
        return params
    top = fetch({k: v for k, v in params.items()
                 if not isinstance(v, dict)})
    return {**params, **top}


def fetched(p, fetch):
    """``fetch(p)`` for one layer's weights, or ``p`` without a fetch."""
    return p if fetch is None else fetch(p)


def run_layer(fn, p: dict, *args, remat: bool = False, fetch=None):
    """``fn(p, *args)`` for one layer's weights ``p``: ``fetch(p)``
    first when given (the FSDP train step's gather of the layer), and
    with ``remat`` under ``torch.utils.checkpoint``, so the layer's
    activations, and the fetch, are recomputed in backward (the
    reference's ``jax.checkpoint`` per layer). With neither it is the
    plain call. The recompute replays ``body``'s ops in their order, so
    the collectives inside it (the fetch, a sequence split's K/V
    gather) run again in the same order on every rank of a group, whose
    graphs are alike; where the checkpoint stops its recompute early,
    it stops at the same op on each."""
    if fetch is None and not remat:
        return fn(p, *args)

    def body(p, *args):
        return fn(p if fetch is None else fetch(p), *args)
    if remat:
        from torch.utils.checkpoint import checkpoint
        return checkpoint(body, p, *args, use_reentrant=False)
    return body(p, *args)


def tree_index(tree, i: int):
    """Row ``i`` of every tensor of a nested dict (views): one layer of
    a stacked layer tree."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_frequencies(head_dim: int, theta: float = 1e4,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, dh); positions: (..., S) integer."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, device=x.device)     # (dh/2,)
    ang = positions[..., None].float() * freqs               # (..., S, dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : dh // 2].float(), x[..., dh // 2:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return F.embedding(ids.long(), table)


def cross_entropy_max_z(logits: torch.Tensor, targets: torch.Tensor,
                        mask: torch.Tensor | None = None,
                        z_weight: float = 2e-4, split=None):
    """CE + auxiliary max-z loss (paper: Yang et al. 2023, weight 2e-4).

    logits: (..., V), upcast to fp32; targets int ids; mask 0/1.
    Returns (loss, metrics dict). Under ``split`` (an
    ``act_hints.LossSplit``: the tokens are this rank's share of a
    worker's batch) the sums are divided by the mask sum of the whole
    batch, all-reduced over the worker's ranks, so the loss and the
    metrics are this rank's terms of the worker's: they add up over
    the ranks to the one batch's values."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    ce = lse - ll
    z = z_weight * lse * lse
    tok = ce + z
    if mask is None:
        mask = torch.ones(tok.shape, dtype=torch.float32, device=tok.device)
    mask = mask.float()
    total = mask.sum() if split is None else split.all_reduce(mask.sum())
    denom = torch.clamp_min(total, 1.0)
    loss = (tok * mask).sum() / denom
    ce_mean = (ce * mask).sum() / denom
    return loss, {"ce": ce_mean, "z": (z * mask).sum() / denom,
                  "loss": loss}
