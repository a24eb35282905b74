"""SSM and hybrid LMs (port of ``repro.models.hybrid``).

* pure Mamba2 stack (mamba2-130m, ``attn_every=None``): SSD layers,
  tied embeddings, attention-free; decode is O(1) per token.
* Zamba2-style hybrid (zamba2-2.7b): a Mamba2 backbone with ONE shared
  attention + MLP block applied after every ``attn_every`` layers (9
  applications at 54 layers), each application with its own
  ``ln_attn`` / ``ln_mlp`` gains, as in the JAX package (which
  simplifies Zamba2's per-application LoRAs away).

The mamba layers stay stacked (leading ``L`` dim) in the JAX package's
layout and run as a Python loop; the shared block is unstacked. The
serving cache is the JAX package's tree ``{"ssm": SSMState stacked (L,
B, ...), "kv": KVCache stacked (n_apps, B, S, Hk, dh) or None}``,
written in place: the shared attention's decode goes through
``attention.cache_update`` + ``decode_attention`` (the flash-decode
kernel on CUDA, its paged variant on a paged cache).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common, ssm
from repro_torch.sharding import act_hints


def ssm_cfg(cfg) -> ssm.SSMConfig:
    return ssm.SSMConfig(d_model=cfg.d_model, d_state=cfg.ssm.d_state,
                         head_dim=cfg.ssm.head_dim,
                         n_groups=cfg.ssm.n_groups,
                         conv_kernel=cfg.ssm.conv_kernel,
                         expand=cfg.ssm.expand, chunk=cfg.ssm.chunk)


def n_apps(cfg) -> int:
    """Applications of the shared block (0 for a pure SSM)."""
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _attn_head_dim(cfg) -> int:
    # the JAX package's hybrid derives it from d_model, not cfg.head_dim
    return cfg.d_model // cfg.n_heads


def alloc_hybrid(cfg, *, device="cuda") -> dict:
    """The parameter tree of ``init_hybrid`` (``repro``'s layout, the
    config's dtype), unfilled but for the ones and zeros: ``embed``,
    ``ln_f``, ``lm_head`` (untied models), the stacked ``mamba`` layers
    (``ln`` and the block's ``mamba`` subtree) and, for a hybrid, the
    ``shared`` block with (n_apps, d) gains. On the ``meta`` device it
    is the abstract tree."""
    def empty(*shape):
        return torch.empty(shape, dtype=cfg.torch_dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.torch_dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.torch_dtype, device=device)

    d, nl = cfg.d_model, cfg.n_layers
    params = {"embed": empty(cfg.padded_vocab, d), "ln_f": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = empty(d, cfg.padded_vocab)
    params["mamba"] = {"ln": ones(nl, d),
                       "mamba": ssm.alloc_mamba2(empty, zeros, ones, (nl,),
                                                 ssm_cfg(cfg))}
    if cfg.attn_every:
        hd, na = _attn_head_dim(cfg), n_apps(cfg)
        hq, hk = cfg.n_heads * hd, cfg.n_kv_heads * hd
        params["shared"] = {
            "ln_attn": ones(na, d), "wq": empty(d, hq), "wk": empty(d, hk),
            "wv": empty(d, hk), "wo": empty(hq, d), "ln_mlp": ones(na, d),
            "mlp": {"gate": empty(d, cfg.d_ff), "up": empty(d, cfg.d_ff),
                    "down": empty(cfg.d_ff, d)}}
    return params


def hybrid_axes(cfg) -> dict:
    """The logical-axes twin of ``alloc_hybrid`` (the reference's
    ``init_hybrid`` axes)."""
    axes = {"embed": ("vocab", "embed"), "ln_f": ("embed",)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    axes["mamba"] = common.stack_layer_axes(
        {"ln": ("embed",), "mamba": ssm.mamba2_axes()})
    if cfg.attn_every:
        axes["shared"] = {
            "ln_attn": (None, "embed"), "wq": ("embed", "heads"),
            "wk": ("embed", "heads"), "wv": ("embed", "heads"),
            "wo": ("heads", "embed"), "ln_mlp": (None, "embed"),
            "mlp": {"gate": ("embed", "ff"), "up": ("embed", "ff"),
                    "down": ("ff", "embed")}}
    return axes


def layer_params(params: dict, i: int) -> dict:
    """Mamba layer ``i``'s views of the stacked tensors."""
    return common.tree_index(params["mamba"], i)


def init_hybrid(cfg, generator: torch.Generator, *, device="cuda") -> dict:
    """Random parameters with ``repro``'s scales and layout; covers both
    families (``cfg.attn_every=None`` is the pure SSM). Each layer is
    drawn in fp32 on ``device`` and cast into its slice of the stack."""
    params = alloc_hybrid(cfg, device=device)
    common.normal_(params["embed"], generator, scale=0.02)
    if not cfg.tie_embeddings:
        common.normal_(params["lm_head"], generator)
    scfg = ssm_cfg(cfg)
    for i in range(cfg.n_layers):
        ssm.init_mamba2(layer_params(params, i)["mamba"], generator, scfg)
    if cfg.attn_every:
        p = params["shared"]
        for name in ("wq", "wk", "wv"):
            common.normal_(p[name], generator)
        common.normal_(p["wo"], generator, scale=p["wo"].shape[0] ** -0.5)
        common.normal_(p["mlp"]["gate"], generator)
        common.normal_(p["mlp"]["up"], generator)
        common.normal_(p["mlp"]["down"], generator, scale=cfg.d_ff ** -0.5)
    return params


# -- blocks -------------------------------------------------------------------


def _shared_attn_apply(cfg, p, x, app_idx: int, *, positions,
                       layer_cache=None):
    """One application of the shared transformer block -> (x, (k, v)).
    With a ``layer_cache`` and one token this is a decode step: K/V go
    into the cache in place and attention runs against it (the
    flash-decode kernel on CUDA)."""
    hd = _attn_head_dim(cfg)
    b, s, _ = x.shape
    h = common.rms_norm(x, p["ln_attn"][app_idx], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    if layer_cache is not None and s == 1:
        attn.cache_update(layer_cache, k, v)
        o = attn.decode_attention(q, layer_cache)
    else:
        o = attn.attention(q, k, v, causal=True, block_q=cfg.block_q)
    x = x + o.reshape(b, s, -1) @ p["wo"]
    h = common.rms_norm(x, p["ln_mlp"][app_idx], cfg.norm_eps)
    x = x + common.swiglu(h, p["mlp"]["gate"], p["mlp"]["up"],
                          p["mlp"]["down"])
    return x, (k, v)


def _head(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def forward(cfg, params, tokens, *, collect_state=False, prompt_len=None,
            remat=False, fetch=None):
    """Training forward (and, with ``collect_state``, the prefill's).
    Plain PyTorch, differentiable.

    ``prompt_len``: (B,) true lengths of a right-padded serving prefill
    (threaded into the SSD mask, see ``ssm.apply_mamba2``). Returns
    (logits (B, S, V), (per-layer SSMStates, per-application (k, v)))
    with ``collect_state``, else (logits, None). ``remat`` checkpoints
    each Mamba layer and each application of the shared block;
    ``fetch`` maps their weights (and the top-level ones) before use
    (``common.run_layer``)."""
    params = common.fetch_top(params, fetch)
    x = common.embedding_lookup(params["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    scfg, ae = ssm_cfg(cfg), cfg.attn_every
    new_states, kvs = [], []

    def mamba_layer(p, x):
        h = common.rms_norm(x, p["ln"], cfg.norm_eps)
        out, new_st = ssm.apply_mamba2(p["mamba"], h, scfg,
                                       return_state=collect_state,
                                       prompt_len=prompt_len)
        return x + out, new_st

    def shared(p, x, app):
        return _shared_attn_apply(cfg, p, x, app, positions=positions)
    for i in range(cfg.n_layers):
        x, new_st = common.run_layer(mamba_layer, layer_params(params, i),
                                     x, remat=remat, fetch=fetch)
        new_states.append(new_st)
        if ae and (i + 1) % ae == 0:
            x, kv = common.run_layer(shared, params["shared"], x,
                                     (i + 1) // ae - 1, remat=remat,
                                     fetch=fetch)
            kvs.append(kv)
    x = common.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _head(cfg, params, x)
    return logits, ((new_states, kvs) if collect_state else None)


def loss_fn(cfg, params, batch, *, remat=False, fetch=None):
    """(loss, metrics) of one batch {"tokens", "targets", "mask"};
    ``remat`` / ``fetch``: see ``forward``. Under an
    ``act_hints.LossSplit`` (the FSDP step's rows split over a worker's
    ranks: each row's scan is whole) the loss and metrics are this
    rank's terms of the worker's."""
    logits, _ = forward(cfg, params, batch["tokens"], remat=remat,
                        fetch=fetch)
    return common.cross_entropy_max_z(logits, batch["targets"],
                                      batch.get("mask"),
                                      z_weight=cfg.max_z_weight,
                                      split=act_hints.loss_split())


# -- serving ------------------------------------------------------------------


def _dummy_states(cfg, batch: int, *, device="cuda") -> ssm.SSMState:
    """Zero SSMStates stacked over the layers: state (L, B, H, P, N)
    fp32, the conv rings (L, B, K-1, C) in the model's dtype."""
    scfg = ssm_cfg(cfg)
    nl, k = cfg.n_layers, scfg.conv_kernel
    gn = scfg.n_groups * scfg.d_state

    def zeros(*shape, dtype=cfg.torch_dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return ssm.SSMState(
        zeros(nl, batch, scfg.n_heads, scfg.head_dim, scfg.d_state,
              dtype=torch.float32),
        zeros(nl, batch, k - 1, scfg.d_inner), zeros(nl, batch, k - 1, gn),
        zeros(nl, batch, k - 1, gn))


def init_cache(cfg, batch_size: int, max_len: int, *, device="cuda") -> dict:
    """The serving cache ``{"ssm": stacked SSMState, "kv": stacked
    KVCache (n_apps, B, max_len, Hk, dh) or None}``; the shared
    attention's cache holds the full context."""
    kv = None
    if cfg.attn_every:
        kv = attn.KVCache.init(n_apps(cfg), batch_size, max_len,
                               cfg.n_kv_heads, _attn_head_dim(cfg),
                               dtype=cfg.torch_dtype, device=device)
    return {"ssm": _dummy_states(cfg, batch_size, device=device), "kv": kv}


@torch.no_grad()
def prefill(cfg, params, tokens, cache, *, prompt_len=None, fetch=None):
    """Run the (right-padded) prompt, fill the (fresh) ``cache`` in
    place -> (last-token logits (B, V), cache): every layer's SSM state
    and conv tails, the shared block's K/V with ``length = prompt_len``
    (or the width), logits gathered at each slot's ``prompt_len - 1``."""
    logits, (states, kvs) = forward(cfg, params, tokens, collect_state=True,
                                    prompt_len=prompt_len, fetch=fetch)
    for big, new in zip(cache["ssm"], zip(*states)):
        big.copy_(torch.stack(new))
    for g, (k, v) in enumerate(kvs):
        c = cache["kv"].layer(g)
        attn.cache_update(c, k, v)
        if prompt_len is not None:
            c.length.copy_(prompt_len)
    if prompt_len is None:
        return logits[:, -1], cache
    idx = (prompt_len.long() - 1)[:, None, None].expand(
        logits.shape[0], 1, logits.shape[-1])
    return torch.gather(logits, 1, idx)[:, 0], cache


@torch.no_grad()
def decode_step(cfg, params, token, cache, *, fetch=None):
    """One decode step. token: (B, 1) -> (logits (B, V), cache), the
    cache advanced in place: each layer's recurrent step, and after
    every ``attn_every`` layers the shared block against its cache.
    RoPE positions come from the per-slot cache lengths. ``fetch`` maps
    each layer's weights (and the top-level ones) before use."""
    params = common.fetch_top(params, fetch)
    x = common.embedding_lookup(params["embed"], token)
    scfg = ssm_cfg(cfg)
    ae = cfg.attn_every
    positions = cache["kv"].length[0][:, None].clone() if ae else None
    for i in range(cfg.n_layers):
        p = common.fetched(layer_params(params, i), fetch)
        h = common.rms_norm(x, p["ln"], cfg.norm_eps)
        out, _ = ssm.decode_mamba2(p["mamba"], h, scfg,
                                   cache["ssm"].layer(i))
        x = x + out
        if ae and (i + 1) % ae == 0:
            g = (i + 1) // ae - 1
            x, _ = _shared_attn_apply(cfg, common.fetched(params["shared"],
                                                          fetch), x, g,
                                      positions=positions,
                                      layer_cache=cache["kv"].layer(g))
    x = common.rms_norm(x, params["ln_f"], cfg.norm_eps)
    return _head(cfg, params, x)[:, 0], cache
