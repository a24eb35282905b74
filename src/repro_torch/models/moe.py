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

Capacity, the top-C choice and ``lb_loss`` depend on every token of a
block, so a batch split over ranks (the FSDP train step), by rows or by
rows and positions (its sequence-parallel branch), routes over the
gathered scores of the whole batch in the reference's b-major token
order (``_moe_split``), as the reference's one SPMD program does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.models import common
from repro_torch.sharding import act_hints

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


def moe_axes(n_shared: int) -> dict:
    """Logical axes of one layer's ``alloc_moe`` subtree (the
    reference's ``init_moe`` axes)."""
    p = {"router": ("embed", None),
         "experts": {"gate": ("experts", "embed", "ff"),
                     "up": ("experts", "embed", "ff"),
                     "down": ("experts", "ff", "embed")}}
    if n_shared:
        p["shared"] = {"gate": ("embed", "ff"), "up": ("embed", "ff"),
                       "down": ("ff", "embed")}
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
              capacity_factor: float = 1.25, full_capacity: bool = False,
              split=None):
    """x: (B, S, d) -> ((B, S, d), {"lb_loss", "dropped_frac"}).

    Tokens go in blocks of ``TOKEN_BLOCK`` when there are more than one
    block's worth and a whole number of blocks (capacity applies per
    block, ``lb_loss`` and ``dropped_frac`` are the blocks' means).
    ``full_capacity``: every token is kept (capacity = all tokens). The
    serving paths set it, so a slot's output never depends on what the
    other slots routed. Under an ``act_hints.BatchSplit`` (a worker's
    batch split over ranks, training) ``x`` is this rank's rows, under
    an ``act_hints.GridSplit`` its rows' positions [lo, hi), and the
    routing is the whole batch's (``_moe_split``). ``split``: that
    split (default: the active hint's)."""
    bsz, seq, d = x.shape
    t = bsz * seq
    xf = x.reshape(t, d)
    if full_capacity:
        split = None
    elif split is None:
        split = act_hints.batch_split()
    if split is not None and split.size > 1:
        out, aux = _moe_split(p, xf, split, top_k=top_k,
                              capacity_factor=capacity_factor)
        return out.reshape(bsz, seq, d), aux
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


def _route(probs: torch.Tensor, top_k: int):
    """fp32 router probabilities (T, E) -> the top-k gates renormalised
    to sum to one, their experts (T, k), and each (token, expert)'s
    score: its gate if selected, else 0 (T, E)."""
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)       # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    sel = torch.zeros(probs.shape, dtype=torch.float32,
                      device=probs.device).scatter(1, gate_idx, gate_vals)
    return gate_idx, sel


def _capacity(t: int, n_experts: int, top_k: int, capacity_factor: float,
              full_capacity: bool) -> int:
    """Tokens each expert takes from a block of ``t``: serving
    (full_capacity) and tiny blocks keep every token; else
    min(t, max(1, int(cf * k * t / E)))."""
    if full_capacity or t <= 64:
        return t
    return min(t, max(1, int(capacity_factor * top_k * t / n_experts)))


def _balance(probs, sel, keep, top_k: int) -> dict:
    """Load-balance auxiliaries of one block (Switch-style): probs and
    sel (T, E), keep the routes the experts took."""
    n_experts = probs.shape[1]
    me = probs.mean(0)                                           # (E,)
    ce = (sel > 0).float().mean(0) * n_experts / top_k
    return {"lb_loss": n_experts * (me * ce).sum(),
            "dropped_frac": 1.0 - keep.sum() / (probs.shape[0] * top_k)}


def _experts(p: dict, xf: torch.Tensor, gate_idx: torch.Tensor,
             top_scores: torch.Tensor, top_tokens: torch.Tensor):
    """Run the experts on their token lists and combine: xf (T, d),
    gate_idx (T, k), top_scores / top_tokens (E, C) each expert's tokens
    and their gates (0: not taken) -> (T, d) in xf's dtype, shared
    experts included."""
    t, d = xf.shape
    n_experts, cap = top_tokens.shape
    dev = xf.device
    top_k = gate_idx.shape[1]
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
    return out.to(xf.dtype)


def _moe_block(p: dict, xf: torch.Tensor, *, top_k: int,
               capacity_factor: float, full_capacity: bool):
    """One token block: (T, d) -> (T, d), aux."""
    t = xf.shape[0]
    n_experts = p["router"].shape[1]
    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)   # (T, E)
    gate_idx, sel = _route(probs, top_k)
    cap = _capacity(t, n_experts, top_k, capacity_factor, full_capacity)
    top_scores, top_tokens = torch.topk(sel.T, cap, dim=-1)      # (E, C)
    out = _experts(p, xf, gate_idx, top_scores, top_tokens)
    return out, _balance(probs, sel, top_scores > 0.0, top_k)


def _moe_split(p: dict, xf: torch.Tensor, split, *, top_k: int,
               capacity_factor: float):
    """``apply_moe`` of this rank's tokens (T_local, d) when the batch is
    split over a group (``act_hints.BatchSplit`` or ``GridSplit``):
    routing as over the whole batch. The fp32 router probabilities are
    gathered in the reference's token order, and the whole batch's
    blocks (``TOKEN_BLOCK``), each expert's top-C and the auxiliaries
    are taken over them, as one device would; then the experts run on
    this rank's tokens that they took (the longest expert's list of
    them). The gather's backward sums the ranks' gradients of the
    auxiliaries, so a step that divides the summed gradient by its rank
    count counts ``lb_loss`` once (a sequence-parallel step, which sums
    its ranks' gradients, divides ``lb_loss`` by the rank count in each
    rank's loss instead: ``act_hints.LossSplit``)."""
    t = xf.shape[0]
    n_experts = p["router"].shape[1]
    probs = torch.softmax((xf @ p["router"]).float(), dim=-1)
    gate_idx, sel = _route(probs, top_k)
    probs_all = split.gather(probs)                              # (T, E)
    t_all = probs_all.shape[0]
    nb = (t_all // TOKEN_BLOCK if t_all > TOKEN_BLOCK
          and t_all % TOKEN_BLOCK == 0 else 1)
    tb = t_all // nb
    cap = _capacity(tb, n_experts, top_k, capacity_factor, False)
    keep = torch.zeros((t_all, n_experts), dtype=torch.bool,
                       device=xf.device)
    lbs, drops = [], []
    for i in range(nb):
        pb = probs_all[i * tb:(i + 1) * tb]
        _, sel_b = _route(pb.detach(), top_k)
        top_scores, top_tokens = torch.topk(sel_b.T, cap, dim=-1)
        taken = top_scores > 0.0
        keep[i * tb:(i + 1) * tb].scatter_(
            0, top_tokens.T, taken.T)
        aux = _balance(pb, sel_b, taken, top_k)
        lbs.append(aux["lb_loss"])
        drops.append(aux["dropped_frac"])
    mine = split.mine(keep)                                      # (T_l, E)
    scores = sel * mine
    # an expert's list is as long as the longest list of this rank's
    # kept tokens (one host sync). On fake tensors (the dry run) it is
    # the rank's share of the capacity, C x blocks x T_local / T, which
    # is what the reference's one program costs a rank
    if isinstance(mine, FakeTensor):
        slots = min(t, max(1, -(-cap * nb * t // t_all)))
    else:
        slots = max(1, int(mine.sum(0).max()))
    top_scores, top_tokens = torch.topk(scores.T, slots, dim=-1)
    out = _experts(p, xf, gate_idx, top_scores, top_tokens)
    return out, {"lb_loss": torch.stack(lbs).sum() / nb,
                 "dropped_frac": torch.stack(drops).mean()}
