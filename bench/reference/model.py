"""Forward pass and training loss of the benchmark's decoder-only models,
in plain PyTorch, from the configuration file alone.

A pre-norm transformer: RMSNorm, grouped-query attention with rotary
embeddings (the rotate-half convention) under a causal mask, and a
SwiGLU feed-forward, or, for a mixture of experts, a softmax router
whose top-k gates are renormalised to sum to one where the
configuration says so, each expert taking
at most C tokens (the highest gates; C = floor(cf * k * T / E), every
token when T <= 64), shared experts on every token and a Switch-style
load-balance loss. The loss is the mean token cross-entropy plus the
max-z term ``z_weight * logsumexp**2`` plus ``lb_weight`` times the
summed load-balance losses.

Parameters are a nested dict in the layout the benchmark makes them in
(``bench/weights.py``): stacked ``layers`` with a leading layer dim,
``dense{i}`` for the leading dense layers of a mixture of experts,
weights applied as ``x @ W``. Every product goes through a
``Precision`` so that the same code computes the reference (fp32, TF32
off) and its lower-precision control (fp8 operands). Each layer and each
block of the head runs under activation checkpointing, so a full-width
step fits beside the optimizer state.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

HEAD_ROWS = 2048          # tokens per block of the head and the loss
ATTN_ROWS = 1024          # queries per block of attention
FP8_MAX = 448.0           # largest finite float8_e4m3fn


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int
    first_dense: int
    renormalise: bool
    capacity_factor: float
    lb_weight: float


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    padded_vocab: int
    rope_theta: float
    eps: float
    z_weight: float
    dtype: torch.dtype
    moe: MoESpec | None = None

    @property
    def n_stacked(self) -> int:
        return self.n_layers - (self.moe.first_dense if self.moe else 0)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def spec_from_config(c: dict) -> ModelSpec:
    """The model a configuration file states (HF key names, plus the
    ``assumed`` sizes the published config leaves out)."""
    a = c["assumed"]
    moe = None
    if c["family"] == "moe":
        moe = MoESpec(n_experts=c["n_routed_experts"],
                      top_k=c["num_experts_per_tok"],
                      d_expert=c["moe_intermediate_size"],
                      n_shared=c["n_shared_experts"],
                      first_dense=c["first_k_dense_replace"],
                      renormalise=a["renormalise_top_k"],
                      capacity_factor=a["capacity_factor"],
                      lb_weight=a["lb_weight"])
    return ModelSpec(
        family=c["family"], n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=a["head_dim"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        padded_vocab=a["padded_vocab_size"], rope_theta=c["rope_theta"],
        eps=c["rms_norm_eps"], z_weight=a["max_z_weight"],
        dtype=_DTYPES[c["torch_dtype"]], moe=moe)


class _RoundFP8(torch.autograd.Function):
    """Round to float8_e4m3fn under a per-tensor scale; the gradient
    passes straight through."""

    @staticmethod
    def forward(ctx, x, scale):
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference multiplies: ``"fp32"`` (the reference itself)
    or ``"fp8"`` (its control: both operands of every product rounded
    to float8_e4m3fn, each tensor scaled so its largest magnitude is
    the format's largest)."""
    name: str = "fp32"

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x
        amax = x.detach().abs().amax().float().clamp_min(1e-30)
        return _RoundFP8.apply(x, FP8_MAX / amax)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.cast(a), self.cast(b))


def rms_norm(x, gamma, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * gamma


def rope(x, theta):
    """x (B, S, H, dh), positions 0..S-1; the two halves of each head
    rotated against each other."""
    s, dh = x.shape[1], x.shape[-1]
    inv = theta ** -(torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None]
           * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(q, k, v, prec: Precision):
    """Causal attention, q (B, S, H, dh), k and v (B, S, Hk, dh): query
    head h reads key head h // (H / Hk). fp32 softmax, in blocks of
    queries."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    outs = []
    for lo in range(0, s, ATTN_ROWS):
        hi = min(s, lo + ATTN_ROWS)
        sc = prec.mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2)) \
            * dh ** -0.5
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        outs.append(prec.mm(torch.softmax(sc, dim=-1), v[:, :, :hi]))
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h * dh)


def swiglu(x, gate, up, down, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, gate)) * prec.mm(x, up), down)


def capacity(t: int, m: MoESpec) -> int:
    if t <= 64:
        return t
    return min(t, max(1, int(m.capacity_factor * m.top_k * t
                             / m.n_experts)))


def moe(p, x, m: MoESpec, prec: Precision):
    """Mixture of experts over the tokens x (T, d) -> ((T, d), lb)."""
    t = x.shape[0]
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    gv, gi = torch.topk(probs, m.top_k, dim=-1)
    if m.renormalise:
        gv = gv / gv.sum(-1, keepdim=True)
    score = torch.zeros_like(probs).scatter(1, gi, gv)
    cap = capacity(t, m)
    if t > 65536:
        raise ValueError("the reference routes one block of at most "
                         "65536 tokens")
    ex = p["experts"]
    out = torch.zeros_like(x)
    for e in range(m.n_experts):
        sc, tok = torch.topk(score[:, e], cap)
        keep = sc > 0
        tok, sc = tok[keep], sc[keep]
        if tok.numel():
            y = swiglu(x[tok], ex["gate"][e], ex["up"][e], ex["down"][e],
                       prec)
            out = out.index_add(0, tok, y * sc[:, None])
    if m.n_shared:
        sh = p["shared"]
        out = out + swiglu(x, sh["gate"], sh["up"], sh["down"], prec)
    load = (score > 0).float().mean(0) * m.n_experts / m.top_k
    return out, m.n_experts * (probs.mean(0) * load).sum()


def _layer(spec: ModelSpec, prec: Precision, p, x):
    b, s, d = x.shape
    hd = spec.head_dim
    h = rms_norm(x, p["ln_attn"], spec.eps)
    q = rope(prec.mm(h, p["wq"]).reshape(b, s, spec.n_heads, hd),
             spec.rope_theta)
    k = rope(prec.mm(h, p["wk"]).reshape(b, s, spec.n_kv_heads, hd),
             spec.rope_theta)
    v = prec.mm(h, p["wv"]).reshape(b, s, spec.n_kv_heads, hd)
    x = x + prec.mm(attention(q, k, v, prec), p["wo"])
    h = rms_norm(x, p["ln_mlp"], spec.eps)
    if "moe" in p:
        f, lb = moe(p["moe"], h.reshape(b * s, d), spec.moe, prec)
        return x + f.reshape(b, s, d), lb
    mp = p["mlp"]
    return x + swiglu(h, mp["gate"], mp["up"], mp["down"], prec), \
        torch.zeros((), device=x.device)


def _head_block(spec: ModelSpec, prec: Precision, x, w, gamma, targets):
    """Summed token loss of one block of rows."""
    logits = prec.mm(rms_norm(x, gamma, spec.eps), w)
    lse = torch.logsumexp(logits, dim=-1)
    ce = lse - torch.gather(logits, -1, targets[:, None].long())[:, 0]
    return (ce + spec.z_weight * lse * lse).sum()


def layers_of(spec: ModelSpec, params):
    """Each layer's parameter dict, in the order the model runs them."""
    n_dense = spec.moe.first_dense if spec.moe else 0
    out = [params[f"dense{i}"] for i in range(n_dense)]
    for i in range(spec.n_stacked):
        out.append(_tree_row(params["layers"], i))
    return out


def _tree_row(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_row(v, i) for k, v in tree.items()}
    return tree[i]


def loss_fn(spec: ModelSpec, params, tokens, targets,
            prec: Precision = Precision()):
    """The loss of one batch, tokens and targets (B, S); ``params`` in
    fp32 (the caller widens the stored ones)."""
    x = params["embed"][tokens.long()]
    lbs = []
    for lp in layers_of(spec, params):
        x, lb = checkpoint(lambda lp, x: _layer(spec, prec, lp, x), lp, x,
                           use_reentrant=False)
        lbs.append(lb)
    xf, tf = x.reshape(-1, x.shape[-1]), targets.reshape(-1)
    tot = torch.zeros((), device=x.device)
    for lo in range(0, xf.shape[0], HEAD_ROWS):
        tot = tot + checkpoint(
            lambda xb, w, g, tb: _head_block(spec, prec, xb, w, g, tb),
            xf[lo:lo + HEAD_ROWS], params["lm_head"], params["ln_f"],
            tf[lo:lo + HEAD_ROWS], use_reentrant=False)
    loss = tot / xf.shape[0]
    if spec.moe is not None:
        loss = loss + spec.moe.lb_weight * torch.stack(lbs).sum()
    return loss
