"""Decoder-only transformer LM (port of ``repro.models.transformer``,
dense family): RMSNorm pre-norm blocks, GQA attention with RoPE, SwiGLU
FFN, optional sliding-window attention, the training forward and loss
(under autograd) and the serving prefill and decode steps.

Layers stay stacked (leading ``L`` dim) in the JAX package's layout and
the layer stack is a Python loop over that dim; KV caches are written in
place. The stage partition of the JAX package (swarm serving) is not
ported yet: ``prefill`` / ``decode_step`` are its one-stage case.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common


def _head_dim(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.n_heads


def _check_dense(cfg) -> None:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port has the "
            "dense family only (MoE, SSM, hybrid and enc-dec are a later "
            "slice)")


def init_lm(cfg, generator: torch.Generator, *, device="cuda") -> dict:
    """Random parameters with ``repro``'s scales and layout. Each layer
    is drawn in fp32 on ``device`` and cast into its slice of the
    stacked tensors, so the fp32 temporaries stay one layer's size."""
    _check_dense(cfg)
    d, hd, n = cfg.d_model, _head_dim(cfg), cfg.n_layers
    hq, hk, ff = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff

    def empty(*shape):
        return torch.empty(shape, dtype=cfg.torch_dtype, device=device)

    params = {"embed": common.normal_(empty(cfg.padded_vocab, d), generator,
                                      scale=0.02),
              "ln_f": torch.ones(d, dtype=cfg.torch_dtype, device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = common.normal_(empty(d, cfg.padded_vocab),
                                           generator)
    layers = {"ln_attn": torch.ones(n, d, dtype=cfg.torch_dtype,
                                    device=device),
              "wq": empty(n, d, hq), "wk": empty(n, d, hk),
              "wv": empty(n, d, hk), "wo": empty(n, hq, d),
              "ln_mlp": torch.ones(n, d, dtype=cfg.torch_dtype,
                                   device=device),
              "mlp": {"gate": empty(n, d, ff), "up": empty(n, d, ff),
                      "down": empty(n, ff, d)}}
    for i in range(n):
        for name in ("wq", "wk", "wv"):
            common.normal_(layers[name][i], generator)
        common.normal_(layers["wo"][i], generator, scale=hq ** -0.5)
        common.normal_(layers["mlp"]["gate"][i], generator)
        common.normal_(layers["mlp"]["up"][i], generator)
        common.normal_(layers["mlp"]["down"][i], generator, scale=ff ** -0.5)
    params["layers"] = layers
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s views of the stacked layer tensors."""
    lay = params["layers"]
    return {"ln_attn": lay["ln_attn"][i], "wq": lay["wq"][i],
            "wk": lay["wk"][i], "wv": lay["wv"][i], "wo": lay["wo"][i],
            "ln_mlp": lay["ln_mlp"][i],
            "mlp": {k: w[i] for k, w in lay["mlp"].items()}}


# -- blocks -------------------------------------------------------------------


def _attn_block(cfg, p, x, *, positions, layer_cache=None, rolling=False):
    """Self-attention sublayer -> (out, (k, v)). With a ``layer_cache``
    and one token this is a decode step: K/V go into the cache in place
    and attention runs against it (the flash-decode kernel on CUDA)."""
    hd = _head_dim(cfg)
    h = common.rms_norm(x, p["ln_attn"], cfg.norm_eps)
    b, s, _ = h.shape
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    if layer_cache is not None and s == 1:           # decode
        attn.cache_update(layer_cache, k, v, rolling=rolling)
        o = attn.decode_attention(q, layer_cache, window=cfg.sliding_window)
    else:                                            # prefill
        o = attn.attention(q, k, v, causal=True, window=cfg.sliding_window,
                           block_q=cfg.block_q)
    return o.reshape(b, s, cfg.n_heads * hd) @ p["wo"], (k, v)


def _ffn_block(cfg, p, x):
    h = common.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return common.swiglu(h, p["mlp"]["gate"], p["mlp"]["up"],
                         p["mlp"]["down"])


def _layer(cfg, p, x, *, positions, layer_cache=None, rolling=False):
    a, kv = _attn_block(cfg, p, x, positions=positions,
                        layer_cache=layer_cache, rolling=rolling)
    x = x + a
    return x + _ffn_block(cfg, p, x), kv


# -- training -----------------------------------------------------------------


def forward(cfg, params, tokens):
    """Training/scoring forward -> logits (B, S, V). Plain PyTorch,
    differentiable (attention is ``attention.attention``). The dense
    family has no auxiliary loss; VLM frontends and remat are not
    ported yet."""
    _check_dense(cfg)
    x = common.embedding_lookup(params["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for i in range(cfg.n_layers):
        x, _ = _layer(cfg, layer_params(params, i), x, positions=positions)
    x = common.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def loss_fn(cfg, params, batch):
    """(loss, metrics) of one batch {"tokens", "targets", "mask"}."""
    if batch.get("frontend") is not None:
        raise NotImplementedError("VLM/audio frontends are not ported yet")
    logits = forward(cfg, params, batch["tokens"])
    return common.cross_entropy_max_z(logits, batch["targets"],
                                      batch.get("mask"),
                                      z_weight=cfg.max_z_weight)


# -- serving ------------------------------------------------------------------


def init_cache(cfg, batch_size: int, max_len: int, *, device="cuda") -> dict:
    """Stacked per-layer KV cache: ``{"scan": KVCache((L, B, S, Hk, dh)),
    "prefix": []}`` (the JAX package's layout; dense models have no
    unstacked prefix layers). SWA models hold a ring of
    min(max_len, window) cells."""
    _check_dense(cfg)
    s_max = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    return {"scan": attn.KVCache.init(cfg.n_layers, batch_size, s_max,
                                      cfg.n_kv_heads, _head_dim(cfg),
                                      dtype=cfg.torch_dtype, device=device),
            "prefix": []}


def _head_logits(cfg, params, x):
    """Final norm + LM head over (B, 1, D) -> (B, V)."""
    x = common.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head)[:, 0]


def _prefill_write(cfg, c: attn.KVCache, k, v, prompt_len) -> None:
    """Write one layer's prompt K/V into its (fresh) cache slice."""
    b, s = k.shape[:2]
    s_max = c.k.shape[1]
    if cfg.sliding_window is not None and (prompt_len is not None
                                           or s > s_max):
        # per-slot ring placement: cell c holds the newest prompt
        # position p == c (mod s_max), p = len-1 - ((len-1-c) mod s_max);
        # cells a short slot never wrote clamp to rows that stay masked
        eff = (prompt_len if prompt_len is not None
               else torch.full((b,), s, dtype=torch.int32, device=k.device))
        cell = torch.arange(s_max, device=k.device)[None, :]
        plen = eff.long()[:, None]
        src = (plen - 1 - torch.remainder(plen - 1 - cell, s_max)
               ).clamp(0, s - 1)
        rows = torch.arange(b, device=k.device)[:, None]
        c.k.copy_(k[rows, src])
        c.v.copy_(v[rows, src])
        c.length.copy_(eff)
        return
    attn.cache_update(c, k, v)
    if prompt_len is not None:
        # pad-tail cells stay garbage; masked by length and overwritten
        # as decode advances
        c.length.copy_(prompt_len)


@torch.no_grad()
def prefill(cfg, params, tokens, cache, *, prompt_len=None):
    """Run the (right-padded) prompt, fill ``cache`` in place ->
    (last-token logits (B, V), cache).

    ``cache`` must be fresh (every length 0). ``prompt_len``: optional
    (B,) int32 true prompt lengths; logits are gathered at each slot's
    ``prompt_len - 1`` and cache lengths set per slot, which is what lets
    admission pad prompts to power-of-two buckets without changing
    outputs."""
    _check_dense(cfg)
    x = common.embedding_lookup(params["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    scan = cache["scan"]
    for i in range(cfg.n_layers):
        x, (k, v) = _layer(cfg, layer_params(params, i), x,
                           positions=positions)
        _prefill_write(cfg, scan.layer(i), k, v, prompt_len)
    if prompt_len is None:
        x_last = x[:, -1:]
    else:
        idx = (prompt_len.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
        x_last = torch.gather(x, 1, idx)
    return _head_logits(cfg, params, x_last), cache


@torch.no_grad()
def decode_step(cfg, params, token, cache):
    """One decode step. token: (B, 1) -> (logits (B, V), cache), the
    cache advanced in place. RoPE positions come from the per-slot cache
    lengths, so slots at different depths each get their own phase."""
    _check_dense(cfg)
    x = common.embedding_lookup(params["embed"], token)
    scan = cache["scan"]
    positions = scan.length[0][:, None].clone()      # (B, 1)
    rolling = cfg.sliding_window is not None
    for i in range(cfg.n_layers):
        x, _ = _layer(cfg, layer_params(params, i), x, positions=positions,
                      layer_cache=scan.layer(i), rolling=rolling)
    return _head_logits(cfg, params, x), cache
