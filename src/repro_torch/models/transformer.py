"""Decoder-only transformer LM (port of ``repro.models.transformer``,
dense family): RMSNorm pre-norm blocks, GQA attention with RoPE, SwiGLU
FFN, optional sliding-window attention, the training forward and loss
(under autograd) and the serving prefill, chunked prefill
(``prefill_extend``) and decode steps, on dense or paged caches.

Layers stay stacked (leading ``L`` dim) in the JAX package's layout and
the layer stack is a Python loop over that dim; KV caches are written in
place. Serving is split at the JAX package's stage-partition seam (see
the serving section): ``prefill`` / ``decode_step`` are the one-stage
case of ``stage_prefill`` / ``stage_decode``.
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


def alloc_lm(cfg, *, device="cuda") -> dict:
    """The parameter tree of ``init_lm`` (``repro``'s layout, the
    config's dtype), unfilled but for the norm gains (ones). On the
    ``meta`` device it is the abstract tree: shapes and dtypes with no
    storage."""
    _check_dense(cfg)
    d, hd, n = cfg.d_model, _head_dim(cfg), cfg.n_layers
    hq, hk, ff = cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.d_ff

    def empty(*shape):
        return torch.empty(shape, dtype=cfg.torch_dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.torch_dtype, device=device)

    params = {"embed": empty(cfg.padded_vocab, d), "ln_f": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = empty(d, cfg.padded_vocab)
    params["layers"] = {"ln_attn": ones(n, d), "wq": empty(n, d, hq),
                        "wk": empty(n, d, hk), "wv": empty(n, d, hk),
                        "wo": empty(n, hq, d), "ln_mlp": ones(n, d),
                        "mlp": {"gate": empty(n, d, ff),
                                "up": empty(n, d, ff),
                                "down": empty(n, ff, d)}}
    return params


def init_lm(cfg, generator: torch.Generator, *, device="cuda") -> dict:
    """Random parameters with ``repro``'s scales and layout. Each layer
    is drawn in fp32 on ``device`` and cast into its slice of the
    stacked tensors, so the fp32 temporaries stay one layer's size."""
    params = alloc_lm(cfg, device=device)
    hq = cfg.n_heads * _head_dim(cfg)
    common.normal_(params["embed"], generator, scale=0.02)
    if not cfg.tie_embeddings:
        common.normal_(params["lm_head"], generator)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        for name in ("wq", "wk", "wv"):
            common.normal_(layers[name][i], generator)
        common.normal_(layers["wo"][i], generator, scale=hq ** -0.5)
        common.normal_(layers["mlp"]["gate"][i], generator)
        common.normal_(layers["mlp"]["up"][i], generator)
        common.normal_(layers["mlp"]["down"][i], generator,
                       scale=cfg.d_ff ** -0.5)
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s views of the stacked layer tensors."""
    lay = params["layers"]
    return {"ln_attn": lay["ln_attn"][i], "wq": lay["wq"][i],
            "wk": lay["wk"][i], "wv": lay["wv"][i], "wo": lay["wo"][i],
            "ln_mlp": lay["ln_mlp"][i],
            "mlp": {k: w[i] for k, w in lay["mlp"].items()}}


# -- blocks -------------------------------------------------------------------


def _qkv(cfg, p, x, positions):
    """Pre-norm Q, K, V projections with RoPE: (B, S, H, dh) each."""
    hd = _head_dim(cfg)
    h = common.rms_norm(x, p["ln_attn"], cfg.norm_eps)
    b, s, _ = h.shape
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    return (common.apply_rope(q, positions, cfg.rope_theta),
            common.apply_rope(k, positions, cfg.rope_theta), v)


def _attn_block(cfg, p, x, *, positions, layer_cache=None, rolling=False):
    """Self-attention sublayer -> (out, (k, v)). With a ``layer_cache``
    and one token this is a decode step: K/V go into the cache in place
    and attention runs against it (the flash-decode kernel on CUDA)."""
    hd = _head_dim(cfg)
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
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
#
# The serving forward is organized around the JAX package's STAGE-PARTITION
# seam: the stacked layer block splits into K contiguous-layer stages, each
# with its own parameter views and KV cache, so a model can be served by a
# chain of machines (``serving/swarm_serve.py``). ``prefill`` /
# ``decode_step`` are thin wrappers over ``stage_prefill`` /
# ``stage_decode`` with ``first=last=True``, so staged and monolithic
# serving share every op (bit-identical by construction).


def n_scan_layers(cfg) -> int:
    return cfg.n_layers - (cfg.moe.first_dense if cfg.moe else 0)


def stage_bounds(cfg, k_stages: int) -> list[tuple[int, int]]:
    """Contiguous partition of the stacked layers into ``k_stages``
    near-equal [lo, hi) ranges (remainder spread over the leading
    stages)."""
    n = n_scan_layers(cfg)
    if not 1 <= k_stages <= n:
        raise ValueError(f"k_stages {k_stages} not in [1, {n}]")
    base, rem = divmod(n, k_stages)
    bounds, lo = [], 0
    for i in range(k_stages):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _slice_rows(tree, lo: int, hi: int):
    """Rows [lo, hi) of every stacked tensor of ``tree``: views, never
    copies (on the ``meta`` device, the abstract slice)."""
    if isinstance(tree, dict):
        return {k: _slice_rows(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def slice_stage_params(cfg, params, lo: int, hi: int, *, first: bool,
                       last: bool) -> dict:
    """The parameter subtree one stage needs: views of its layer-stack
    rows, plus the embedding on the first stage and the final norm and
    head on the last (tied embeddings put the embedding on the last
    stage too)."""
    sp = {"layers": _slice_rows(params["layers"], lo, hi)}
    if first:
        sp["embed"] = params["embed"]
    if last:
        sp["ln_f"] = params["ln_f"]
        if cfg.tie_embeddings:
            sp["embed"] = params["embed"]
        else:
            sp["lm_head"] = params["lm_head"]
    return sp


def _init_cache_range(cfg, batch_size: int, max_len: int, lo: int, hi: int,
                      *, device) -> dict:
    _check_dense(cfg)
    s_max = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    return {"scan": attn.KVCache.init(hi - lo, batch_size, s_max,
                                      cfg.n_kv_heads, _head_dim(cfg),
                                      dtype=cfg.torch_dtype, device=device),
            "prefix": []}


def init_cache(cfg, batch_size: int, max_len: int, *, device="cuda") -> dict:
    """Stacked per-layer KV cache: ``{"scan": KVCache((L, B, S, Hk, dh)),
    "prefix": []}`` (the JAX package's layout; dense models have no
    unstacked prefix layers). SWA models hold a ring of
    min(max_len, window) cells."""
    return _init_cache_range(cfg, batch_size, max_len, 0, n_scan_layers(cfg),
                             device=device)


def init_stage_cache(cfg, batch_size: int, max_len: int, lo: int, hi: int,
                     *, device="cuda") -> dict:
    """Per-stage cache: the KV stack of layers [lo, hi) (the dense
    family has no unstacked prefix layers to ride with stage 0)."""
    return _init_cache_range(cfg, batch_size, max_len, lo, hi, device=device)


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
def stage_prefill(cfg, params, inp, cache, *, first: bool, last: bool,
                  prompt_len=None):
    """Prefill one stage's layers over the full (right-padded) prompt,
    filling its (fresh: every length 0) ``cache`` in place.

    ``inp``: (B, S) tokens when ``first`` else (B, S, D) activations from
    the previous stage. Returns ``(out, cache)``: the (B, V) last-token
    logits when ``last`` (gathered at each slot's ``prompt_len - 1``),
    else the full-width (B, S, D) activations for the next stage.

    ``prompt_len``: optional (B,) int32 true prompt lengths; cache
    lengths are then set per slot, which is what lets admission pad
    prompts to power-of-two buckets without changing outputs."""
    _check_dense(cfg)
    x = common.embedding_lookup(params["embed"], inp) if first else inp
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    scan = cache["scan"]
    for i in range(scan.k.shape[0]):
        x, (k, v) = _layer(cfg, layer_params(params, i), x,
                           positions=positions)
        _prefill_write(cfg, scan.layer(i), k, v, prompt_len)
    if not last:
        return x, cache
    if prompt_len is None:
        x_last = x[:, -1:]
    else:
        idx = (prompt_len.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
        x_last = torch.gather(x, 1, idx)
    return _head_logits(cfg, params, x_last), cache


@torch.no_grad()
def stage_decode(cfg, params, inp, cache, *, first: bool, last: bool):
    """One decode step through one stage's layers, the cache advanced in
    place.

    ``inp``: (B, 1) token ids when ``first`` else (B, 1, D) activations.
    Returns ``(out, cache)``: (B, V) logits when ``last`` else (B, 1, D)
    activations. RoPE positions come from the per-slot cache lengths,
    so slots at different depths each get their own phase, and every
    stage derives them from its own cache (a chain's stages advance in
    lockstep)."""
    _check_dense(cfg)
    x = common.embedding_lookup(params["embed"], inp) if first else inp
    scan = cache["scan"]
    positions = scan.length[0][:, None].clone()      # (B, 1)
    rolling = cfg.sliding_window is not None
    for i in range(scan.k.shape[0]):
        x, _ = _layer(cfg, layer_params(params, i), x, positions=positions,
                      layer_cache=scan.layer(i), rolling=rolling)
    if not last:
        return x, cache
    return _head_logits(cfg, params, x), cache


def prefill(cfg, params, tokens, cache, *, prompt_len=None):
    """Run the (right-padded) prompt, fill ``cache`` in place ->
    (last-token logits (B, V), cache). The one-stage case of
    ``stage_prefill``."""
    return stage_prefill(cfg, params, tokens, cache, first=True, last=True,
                         prompt_len=prompt_len)


@torch.no_grad()
def prefill_extend(cfg, params, tokens, cache, *, start: int, seg_len: int):
    """Chunked prefill: run one right-padded prompt SEGMENT at absolute
    offset ``start`` against an already-partial cache, written in place.

    ``tokens``: (B, S) segment; ``start``: absolute position of
    tokens[:, 0], equal to the cache's per-slot ``length`` (the write
    cursor); ``seg_len``: true segment length (<= S). Returns
    (last-token logits (B, V), cache with ``length = start + seg_len``).

    Each layer writes the segment's K/V through ``cache_update`` and
    every query row attends over the whole live prefix (the paged
    cache's dense view, earlier segments included), so chaining
    segments reproduces a single-shot ``prefill``. Full-causal only: an
    SWA ring has no stable absolute cells to resume into."""
    _check_dense(cfg)
    if cfg.sliding_window is not None:
        raise ValueError("prefill_extend is full-causal only (SWA "
                         "rings roll; resume offsets are undefined)")
    start, seg_len = int(start), int(seg_len)
    x = common.embedding_lookup(params["embed"], tokens)
    b, s, _ = x.shape
    hd = _head_dim(cfg)
    positions = (start + torch.arange(s, device=x.device))[None].expand(b, s)
    scan = cache["scan"]
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        c = scan.layer(i)
        q, k, v = _qkv(cfg, p, x, positions)
        attn.cache_update(c, k, v)                   # writes at length
        view = attn.paged_view(c) if isinstance(c, attn.PagedKVCache) \
            else c
        o = attn.attention(q, view.k, view.v, causal=True, q_offset=start,
                           block_q=cfg.block_q)
        x = x + o.reshape(b, s, cfg.n_heads * hd) @ p["wo"]
        x = x + _ffn_block(cfg, p, x)
    # cache_update advanced length by the PADDED width; the true cursor
    # is start + seg_len
    scan.length.fill_(start + seg_len)
    return _head_logits(cfg, params, x[:, seg_len - 1:seg_len]), cache


def decode_step(cfg, params, token, cache):
    """One decode step. token: (B, 1) -> (logits (B, V), cache), the
    cache advanced in place. The one-stage case of ``stage_decode``."""
    return stage_decode(cfg, params, token, cache, first=True, last=True)
