"""Shared model substrate (port of ``repro.models.common``): the
parameter initializer, RMSNorm, RoPE, SwiGLU, the embedding gather and
the training loss (cross-entropy + max-z).

Parameters are plain nested dicts of tensors with the JAX package's
layout (stacked ``(L, ...)`` layers, ``x @ W`` weight orientation), so
converting ``repro`` weights is a copy. ``repro.sharding.act_hints``'s
``hint_residual`` is a sharding constraint that is a no-op on one device
and has no counterpart here.
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
                        z_weight: float = 2e-4):
    """CE + auxiliary max-z loss (paper: Yang et al. 2023, weight 2e-4).

    logits: (..., V), upcast to fp32; targets int ids; mask 0/1.
    Returns (loss, metrics dict)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    ce = lse - ll
    z = z_weight * lse * lse
    tok = ce + z
    if mask is None:
        mask = torch.ones(tok.shape, dtype=torch.float32, device=tok.device)
    mask = mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (tok * mask).sum() / denom
    ce_mean = (ce * mask).sum() / denom
    return loss, {"ce": ce_mean, "z": (z * mask).sum() / denom,
                  "loss": loss}
