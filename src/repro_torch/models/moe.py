"""Mixture-of-Experts FFN (port of ``repro.models.moe``; deepseek-moe-16b:
2 shared + 64 routed top-6, dbrx-132b: 16 routed top-4).

Dispatch is the JAX package's capacity-based formulation (GShard-style
token dropping), with its semantics:

  1. fp32 router softmax -> top-k experts per token, the k gates
     renormalised to sum to one;
  2. per expert, the top-C tokens by gate score (C = capacity);
  3. those tokens gathered into (E, C, d) and run through the expert
     SwiGLU as batched matrix products (``torch.matmul`` over the
     leading E dim: plain products the reference computes outside any
     Pallas kernel);
  4. the weighted outputs combined back per token; shared experts
     (DeepSeek-MoE) are a plain SwiGLU on every token.

The combine differs from the reference's in its order only. The JAX
package scatter-adds the (E*C, d) rows into (T, d); on CUDA a float
``index_add_`` / ``scatter_add_`` is atomic, so its sums would depend on
the order the card's threads land in and a bitwise gate (paged ==
dense engine, staged == monolithic) could fail from run to run. Here
every token GATHERS its k routed rows instead (a dropped one reads a
zero row) and adds them in fp32 in its top-k order, highest gate first,
then casts to the activations' dtype: no atomics, the same bits every
run. Sums in another order agree with the reference within rounding
(``tests/test_torch_moe.py`` holds them with ``allclose``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common

TOKEN_BLOCK = 65536


def alloc_moe(empty, lead: tuple, d_model: int, d_expert: int,
              n_experts: int, n_shared: int) -> dict:
    """One MoE FFN's parameter subtree in ``repro``'s layout, each
    tensor ``empty(*lead, ...)`` (``lead`` = (L,) for a layer stack):
    ``router (d, E)``, ``experts/{gate,up} (E, d, f)``, ``experts/down
    (E, f, d)`` and, with shared experts, ``shared/{gate,up} (d, S*f)``
    and ``shared/down (S*f, d)``."""
    p = {"router": empty(*lead, d_model, n_experts),
         "experts": {"gate": empty(*lead, n_experts, d_model, d_expert),
                     "up": empty(*lead, n_experts, d_model, d_expert),
                     "down": empty(*lead, n_experts, d_expert, d_model)}}
    if n_shared:
        fs = n_shared * d_expert
        p["shared"] = {"gate": empty(*lead, d_model, fs),
                       "up": empty(*lead, d_model, fs),
                       "down": empty(*lead, fs, d_model)}
    return p


def init_moe(p: dict, generator: torch.Generator, d_model: int,
             d_expert: int, n_shared: int) -> None:
    """Fill one layer's MoE tensors (views) with ``repro``'s scales:
    router d ** -0.5, expert gate/up fan_in = shape[0] (E), down
    d_expert ** -0.5, shared down (S * d_expert) ** -0.5."""
    common.normal_(p["router"], generator, scale=d_model ** -0.5)
    common.normal_(p["experts"]["gate"], generator)
    common.normal_(p["experts"]["up"], generator)
    common.normal_(p["experts"]["down"], generator, scale=d_expert ** -0.5)
    if n_shared:
        common.normal_(p["shared"]["gate"], generator)
        common.normal_(p["shared"]["up"], generator)
        common.normal_(p["shared"]["down"], generator,
                       scale=(n_shared * d_expert) ** -0.5)


def apply_moe(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, full_capacity: bool = False):
    """x: (B, S, d) -> ((B, S, d), {"lb_loss", "dropped_frac"}).

    Tokens go in blocks of ``TOKEN_BLOCK`` when there are more than one
    block's worth and a whole number of blocks (capacity applies per
    block, ``lb_loss`` and ``dropped_frac`` are the blocks' means).
    ``full_capacity``: every token is kept (capacity = all tokens). The
    serving paths set it, so a slot's output never depends on what the
    other slots routed."""
    bsz, seq, d = x.shape
    t = bsz * seq
    xf = x.reshape(t, d)
    if t > TOKEN_BLOCK and t % TOKEN_BLOCK == 0:
        outs, lbs, drops = [], [], []
        for xb in xf.split(TOKEN_BLOCK):
            yb, aux = _moe_block(p, xb, top_k=top_k,
                                 capacity_factor=capacity_factor,
                                 full_capacity=full_capacity)
            outs.append(yb)
            lbs.append(aux["lb_loss"])
            drops.append(aux["dropped_frac"])
        return (torch.cat(outs).reshape(bsz, seq, d),
                {"lb_loss": torch.stack(lbs).sum() / len(lbs),
                 "dropped_frac": torch.stack(drops).mean()})
    out, aux = _moe_block(p, xf, top_k=top_k,
                          capacity_factor=capacity_factor,
                          full_capacity=full_capacity)
    return out.reshape(bsz, seq, d), aux


def _moe_block(p: dict, xf: torch.Tensor, *, top_k: int,
               capacity_factor: float, full_capacity: bool):
    """One token block: (T, d) -> (T, d), aux."""
    t, d = xf.shape
    n_experts = p["router"].shape[1]
    dev = xf.device

    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)   # (T, E)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)       # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # score of each (token, expert): its gate if selected, else 0
    sel = torch.zeros((t, n_experts), dtype=torch.float32,
                      device=dev).scatter(1, gate_idx, gate_vals)

    # serving (full_capacity) and tiny blocks keep every token; else each
    # expert takes min(t, max(1, int(cf * k * t / E))) of them
    cap = t if full_capacity or t <= 64 else min(t, max(1, int(
        capacity_factor * top_k * t / n_experts)))
    top_scores, top_tokens = torch.topk(sel.T, cap, dim=-1)      # (E, C)
    keep = top_scores > 0.0

    xe = xf[top_tokens.reshape(-1)].reshape(n_experts, cap, d)
    ex = p["experts"]
    ye = torch.matmul(F.silu(torch.matmul(xe, ex["gate"]))
                      * torch.matmul(xe, ex["up"]), ex["down"])  # (E, C, d)
    w = (top_scores * keep).to(ye.dtype)[..., None]
    upd = torch.cat([(ye * w).reshape(-1, d),
                     torch.zeros((1, d), dtype=ye.dtype, device=dev)])

    # the combine, as a gather: slot[e, tok] = where token tok sits in
    # expert e's list (-1: not there); each token reads its k routed
    # rows (a dropped one the zero row at E*C) and sums them in fp32 in
    # its top-k order
    slot = torch.full((n_experts, t), -1, dtype=torch.long, device=dev)
    slot.scatter_(1, top_tokens, torch.arange(cap, device=dev).expand(
        n_experts, cap).contiguous())
    pos = slot[gate_idx, torch.arange(t, device=dev)[:, None]]   # (T, k)
    row = torch.where(pos >= 0, gate_idx * cap + pos, n_experts * cap)
    picked = upd[row]                                            # (T, k, d)
    acc = picked[:, 0].float()
    for j in range(1, top_k):
        acc = acc + picked[:, j].float()
    out = acc.to(ye.dtype)

    if "shared" in p:
        sh = p["shared"]
        out = out + common.swiglu(xf, sh["gate"], sh["up"],
                                  sh["down"]).to(out.dtype)

    # load-balance auxiliaries (Switch-style)
    me = probs.mean(0)                                           # (E,)
    ce = (sel > 0).float().mean(0) * n_experts / top_k
    aux = {"lb_loss": n_experts * (me * ce).sum(),
           "dropped_frac": 1.0 - keep.sum() / (t * top_k)}
    return out.to(xf.dtype), aux
