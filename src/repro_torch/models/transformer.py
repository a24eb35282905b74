"""Decoder-only transformer LM (port of ``repro.models.transformer``;
the dense, MoE and VLM families): RMSNorm pre-norm blocks, GQA attention
with RoPE, a SwiGLU or MoE FFN (``models.moe``), optional sliding-window
attention and multimodal prefix embeddings (a VLM's ``frontend``), the
training forward and loss (under autograd) and the serving prefill,
chunked prefill (``prefill_extend``) and decode steps, on dense or paged
caches.

Layers stay stacked (leading ``L`` dim) in the JAX package's layout and
the layer stack is a Python loop over that dim; leading dense layers
(DeepSeek-MoE's first-layer-dense, ``dense{i}``) are kept unstacked and
run first, with their own unstacked caches (``cache["prefix"]``). KV
caches are written in place. Serving is split at the JAX package's
stage-partition seam (see the serving section): ``prefill`` /
``decode_step`` are the one-stage case of ``stage_prefill`` /
``stage_decode``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common, moe
from repro_torch.sharding import act_hints


def _head_dim(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.n_heads


def n_dense_prefix(cfg) -> int:
    """Leading dense-FFN layers kept unstacked (``dense{i}``)."""
    return cfg.moe.first_dense if cfg.moe else 0


def _alloc_layer(cfg, empty, ones, lead: tuple, is_moe: bool) -> dict:
    d, hd = cfg.d_model, _head_dim(cfg)
    hq, hk = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"ln_attn": ones(*lead, d), "wq": empty(*lead, d, hq),
         "wk": empty(*lead, d, hk), "wv": empty(*lead, d, hk),
         "wo": empty(*lead, hq, d), "ln_mlp": ones(*lead, d)}
    if is_moe:
        m = cfg.moe
        p["moe"] = moe.alloc_moe(empty, lead, d, m.d_expert, m.n_experts,
                                 m.n_shared)
    else:
        p["mlp"] = {"gate": empty(*lead, d, cfg.d_ff),
                    "up": empty(*lead, d, cfg.d_ff),
                    "down": empty(*lead, cfg.d_ff, d)}
    return p


def alloc_lm(cfg, *, device="cuda") -> dict:
    """The parameter tree of ``init_lm`` (``repro``'s layout, the
    config's dtype), unfilled but for the norm gains (ones): the stacked
    ``layers`` (an MoE FFN subtree ``moe`` on MoE models, else ``mlp``)
    and the unstacked dense-prefix layers ``dense{i}``. On the ``meta``
    device it is the abstract tree: shapes and dtypes with no storage."""
    def empty(*shape):
        return torch.empty(shape, dtype=cfg.torch_dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.torch_dtype, device=device)

    d = cfg.d_model
    params = {"embed": empty(cfg.padded_vocab, d), "ln_f": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = empty(d, cfg.padded_vocab)
    params["layers"] = _alloc_layer(cfg, empty, ones, (n_scan_layers(cfg),),
                                    cfg.moe is not None)
    for i in range(n_dense_prefix(cfg)):
        params[f"dense{i}"] = _alloc_layer(cfg, empty, ones, (), False)
    return params


def _layer_axes(cfg, is_moe: bool) -> dict:
    p = {"ln_attn": ("embed",), "wq": ("embed", "heads"),
         "wk": ("embed", "heads"), "wv": ("embed", "heads"),
         "wo": ("heads", "embed"), "ln_mlp": ("embed",)}
    if is_moe:
        p["moe"] = moe.moe_axes(cfg.moe.n_shared)
    else:
        p["mlp"] = {"gate": ("embed", "ff"), "up": ("embed", "ff"),
                    "down": ("ff", "embed")}
    return p


def lm_axes(cfg) -> dict:
    """The logical-axes twin of ``alloc_lm``: one axis name per dim of
    every parameter (the reference's ``init_lm`` axes), the stacked
    layers led by ``"layers"``."""
    axes = {"embed": ("vocab", "embed"), "ln_f": ("embed",)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    axes["layers"] = common.stack_layer_axes(
        _layer_axes(cfg, cfg.moe is not None))
    for i in range(n_dense_prefix(cfg)):
        axes[f"dense{i}"] = _layer_axes(cfg, False)
    return axes


def _init_layer(cfg, p: dict, generator: torch.Generator) -> None:
    """Fill one layer's tensors (views) with ``repro``'s scales."""
    hq = cfg.n_heads * _head_dim(cfg)
    for name in ("wq", "wk", "wv"):
        common.normal_(p[name], generator)
    common.normal_(p["wo"], generator, scale=hq ** -0.5)
    if "moe" in p:
        m = cfg.moe
        moe.init_moe(p["moe"], generator, cfg.d_model, m.d_expert,
                     m.n_shared)
        return
    common.normal_(p["mlp"]["gate"], generator)
    common.normal_(p["mlp"]["up"], generator)
    common.normal_(p["mlp"]["down"], generator, scale=cfg.d_ff ** -0.5)


def init_lm(cfg, generator: torch.Generator, *, device="cuda") -> dict:
    """Random parameters with ``repro``'s scales and layout. Each layer
    is drawn in fp32 on ``device`` and cast into its slice of the
    stacked tensors, so the fp32 temporaries stay one tensor of one
    layer in size."""
    params = alloc_lm(cfg, device=device)
    common.normal_(params["embed"], generator, scale=0.02)
    if not cfg.tie_embeddings:
        common.normal_(params["lm_head"], generator)
    for i in range(n_scan_layers(cfg)):
        _init_layer(cfg, layer_params(params, i), generator)
    for i in range(n_dense_prefix(cfg)):
        _init_layer(cfg, params[f"dense{i}"], generator)
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s views of the stacked layer tensors."""
    return common.tree_index(params["layers"], i)


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


def _attn_block(cfg, p, x, *, positions, layer_cache=None, rolling=False,
                split=None):
    """Self-attention sublayer -> (out, (k, v)). With a ``layer_cache``
    and one token this is a decode step: K/V go into the cache in place
    and attention runs against it (the flash-decode kernel on CUDA).
    ``split``: the sequence split of this rank's positions (default:
    the active hint's); K/V are gathered over its group."""
    hd = _head_dim(cfg)
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions)
    split = split or act_hints.seq_split()
    if layer_cache is not None and s == 1:           # decode
        attn.cache_update(layer_cache, k, v, rolling=rolling)
        o = attn.decode_attention(q, layer_cache, window=cfg.sliding_window)
    elif split is not None:          # positions [lo, hi) of the stream
        k, v = split.gather_seq(k), split.gather_seq(v)
        o = attn.attention(q, k, v, causal=True, window=cfg.sliding_window,
                           q_offset=split.lo, block_q=cfg.block_q)
    else:                                            # prefill
        o = attn.attention(q, k, v, causal=True, window=cfg.sliding_window,
                           block_q=cfg.block_q)
    return o.reshape(b, s, cfg.n_heads * hd) @ p["wo"], (k, v)


def _ffn_block(cfg, p, x, serving: bool = False, tokens=None):
    """FFN sublayer -> (out, aux): an MoE layer (``moe`` in ``p``)
    returns its ``lb_loss`` and ``dropped_frac``, a dense one ``{}``.
    ``serving`` forces full capacity: a slot's tokens must never depend
    on what the other slots routed. ``tokens``: the split of a worker's
    tokens the routing gathers over (default: the active hint's)."""
    h = common.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if "moe" in p:
        return moe.apply_moe(p["moe"], h, top_k=cfg.moe.top_k,
                             capacity_factor=cfg.moe.capacity_factor,
                             full_capacity=serving, split=tokens)
    return common.swiglu(h, p["mlp"]["gate"], p["mlp"]["up"],
                         p["mlp"]["down"]), {}


def _layer(cfg, p, x, *, positions, layer_cache=None, rolling=False,
           serving=False, split=None, tokens=None):
    a, kv = _attn_block(cfg, p, x, positions=positions,
                        layer_cache=layer_cache, rolling=rolling,
                        split=split)
    x = x + a
    f, aux = _ffn_block(cfg, p, x, serving, tokens)
    return x + f, kv, aux


def _stage_layers(cfg, params, n_scan: int, first: bool) -> list[dict]:
    """The layers a stage runs, in order: the dense prefix (first stage
    only), then its ``n_scan`` rows of the stack."""
    prefix = [params[f"dense{i}"] for i in range(n_dense_prefix(cfg))] \
        if first else []
    return prefix + [layer_params(params, i) for i in range(n_scan)]


# -- training -----------------------------------------------------------------


def _stream(cfg, params, tokens, frontend, lo: int, hi: int):
    """Positions [lo, hi) of the residual stream's input: the frontend's
    (a VLM's first F positions) and the embeddings of the tokens after
    them, so a rank embeds only its own tokens."""
    nf = 0 if frontend is None else frontend.shape[1]
    x = common.embedding_lookup(params["embed"],
                                tokens[:, max(lo - nf, 0):max(hi - nf, 0)])
    if lo < nf:
        x = torch.cat([frontend[:, lo:min(hi, nf)].to(x.dtype), x], dim=1)
    return x


def forward(cfg, params, tokens, *, frontend=None, remat=False, fetch=None):
    """Training/scoring forward -> (logits (B, F + S, V), aux). Plain
    PyTorch, differentiable (attention is ``attention.attention``).
    ``frontend``: optional (B, F, d_model) embeddings (a VLM's image
    patches) prepended to the token embeddings. The dense prefix layers
    run first; ``aux["lb_loss"]`` is the MoE layers' summed load-balance
    loss (0 without MoE) and, on MoE models, ``aux["dropped_frac"]``
    their mean share of dropped routes. ``remat`` checkpoints each
    layer; ``fetch`` maps each layer's weights (and the top-level ones)
    before use (``common.run_layer``).

    Under an ``act_hints.SeqSplit`` (the sequence-parallel train step)
    the split is laid over the F + S positions of the stream and this
    rank runs positions [lo, hi) of it: its own tokens embedded, RoPE
    and the causal mask (and a sliding window) at global positions, K/V
    gathered over the group in every layer (the gather's backward sums
    the group's gradients), the MoE routing over the worker's token
    grid (``act_hints.GridSplit``); the logits are its positions'. The
    layer closure holds both splits, so a rematerialised layer gathers
    as its forward did."""
    params = common.fetch_top(params, fetch)
    split = act_hints.seq_split()
    tok_split = act_hints.batch_split()
    nf = 0 if frontend is None else frontend.shape[1]
    if split is not None:
        split = split.over(nf + tokens.shape[1])
        if tok_split is not None:
            tok_split = tok_split.over(nf + tokens.shape[1])
        x = _stream(cfg, params, tokens, frontend, split.lo, split.hi)
    else:
        x = common.embedding_lookup(params["embed"], tokens)
        if frontend is not None:
            x = torch.cat([frontend.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    lo = 0 if split is None else split.lo
    positions = torch.arange(lo, lo + s, device=x.device)[None].expand(b, s)
    lbs, drops = [], []
    def layer(p, x):
        return _layer(cfg, p, x, positions=positions, split=split,
                      tokens=tok_split)
    for p in _stage_layers(cfg, params, n_scan_layers(cfg), True):
        x, _, aux = common.run_layer(layer, p, x, remat=remat, fetch=fetch)
        if aux:
            lbs.append(aux["lb_loss"])
            drops.append(aux["dropped_frac"])
    x = common.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = {"lb_loss": torch.stack(lbs).sum() if lbs
           else torch.zeros((), device=x.device)}
    if drops:
        out["dropped_frac"] = torch.stack(drops).mean()
    return x @ head, out


def loss_fn(cfg, params, batch, *, remat=False, fetch=None):
    """(loss, metrics) of one batch {"tokens", "targets", "mask"} and,
    for a VLM, "frontend" (B, F, d_model): its F positions are sliced
    off the logits before the loss. MoE models add ``lb_weight`` x the
    load-balance loss and report ``lb_loss`` and ``dropped_frac``.
    ``remat`` / ``fetch``: see ``forward``.

    Under a sequence split the rank scores its positions of the stream
    that have targets (positions >= F), and under an
    ``act_hints.LossSplit`` the loss and every metric are its terms of
    the worker's (``common.cross_entropy_max_z``; ``lb_loss`` and
    ``dropped_frac``, whole on every rank, divided by the rank count),
    which add up over the ranks to the one batch's."""
    frontend = batch.get("frontend")
    logits, aux = forward(cfg, params, batch["tokens"], frontend=frontend,
                          remat=remat, fetch=fetch)
    nf = 0 if frontend is None else frontend.shape[1]
    targets, mask = batch["targets"], batch.get("mask")
    split = act_hints.seq_split()
    if split is not None:
        sp = split.over(nf + targets.shape[1])
        t_lo, t_hi = max(sp.lo - nf, 0), max(sp.hi - nf, 0)
        targets = targets[:, t_lo:t_hi]
        mask = None if mask is None else mask[:, t_lo:t_hi]
        logits = logits[:, max(nf - sp.lo, 0):]
    else:
        logits = logits[:, nf:]
    ls = act_hints.loss_split()
    loss, metrics = common.cross_entropy_max_z(
        logits, targets, mask, z_weight=cfg.max_z_weight, split=ls)
    if cfg.moe is not None:
        lb, dropped = aux["lb_loss"], aux["dropped_frac"]
        if ls is not None:
            lb, dropped = lb / ls.n, dropped / ls.n
        loss = loss + cfg.moe.lb_weight * lb
        metrics["lb_loss"] = lb
        metrics["dropped_frac"] = dropped
    metrics["loss"] = loss
    return loss, metrics


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
    stages). Dense-prefix layers ride with stage 0."""
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
    rows, plus the embedding and the dense prefix layers on the first
    stage and the final norm and head on the last (tied embeddings put
    the embedding on the last stage too)."""
    sp = {"layers": _slice_rows(params["layers"], lo, hi)}
    if first:
        sp["embed"] = params["embed"]
        for i in range(n_dense_prefix(cfg)):
            sp[f"dense{i}"] = params[f"dense{i}"]
    if last:
        sp["ln_f"] = params["ln_f"]
        if cfg.tie_embeddings:
            sp["embed"] = params["embed"]
        else:
            sp["lm_head"] = params["lm_head"]
    return sp


def _init_cache_range(cfg, batch_size: int, max_len: int, lo: int, hi: int,
                      *, first: bool, device) -> dict:
    s_max = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len

    def stack(n):
        return attn.KVCache.init(n, batch_size, s_max, cfg.n_kv_heads,
                                 _head_dim(cfg), dtype=cfg.torch_dtype,
                                 device=device)
    n_prefix = n_dense_prefix(cfg) if first else 0
    return {"scan": stack(hi - lo),
            "prefix": [stack(1).layer(0) for _ in range(n_prefix)]}


def init_cache(cfg, batch_size: int, max_len: int, *, device="cuda") -> dict:
    """Per-layer KV cache in the JAX package's layout: ``{"scan":
    KVCache((L, B, S, Hk, dh)), "prefix": [KVCache((B, S, Hk, dh)), ...]}``
    with one unstacked cache per dense-prefix layer (empty for models
    without one). SWA models hold a ring of min(max_len, window) cells."""
    return _init_cache_range(cfg, batch_size, max_len, 0, n_scan_layers(cfg),
                             first=True, device=device)


def init_stage_cache(cfg, batch_size: int, max_len: int, lo: int, hi: int,
                     *, first: bool, device="cuda") -> dict:
    """Per-stage cache: the KV stack of layers [lo, hi), plus the dense
    prefix layers' caches when this is the first stage."""
    return _init_cache_range(cfg, batch_size, max_len, lo, hi, first=first,
                             device=device)


def _head_logits(cfg, params, x):
    """Final norm + LM head over (B, 1, D) -> (B, V)."""
    x = common.rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head)[:, 0]


def _stage_caches(cache) -> list:
    """One cache view per layer, in ``_stage_layers``' order: the dense
    prefix's caches, then the rows of the stack."""
    scan = cache["scan"]
    return list(cache["prefix"]) + [scan.layer(i)
                                    for i in range(scan.k.shape[0])]


def _prefill_write(cfg, c: attn.KVCache, k, v, prompt_len) -> None:
    """Write one layer's prompt K/V into its (fresh) cache slice (a
    ``ShardedKVCache``: its block of it)."""
    if isinstance(c, attn.ShardedKVCache):
        c.write(lambda cc, kk, vv: _prefill_write(cfg, cc, kk, vv,
                                                  prompt_len), k, v)
        return
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
                  prompt_len=None, frontend=None, fetch=None):
    """Prefill one stage's layers over the full (right-padded) prompt,
    filling its (fresh: every length 0) ``cache`` in place.

    ``inp``: (B, S) tokens when ``first`` else (B, S, D) activations from
    the previous stage. Returns ``(out, cache)``: the (B, V) last-token
    logits when ``last`` (gathered at each slot's ``prompt_len - 1``),
    else the full-width (B, S, D) activations for the next stage.

    ``prompt_len``: optional (B,) int32 true prompt lengths; cache
    lengths are then set per slot, which is what lets admission pad
    prompts to power-of-two buckets without changing outputs.
    ``frontend``: optional (B, F, d_model) embeddings prepended to the
    tokens' on the first stage (a VLM's image patches); positions and
    ``prompt_len`` then count them. ``fetch`` maps each layer's weights
    (and the top-level ones) before use (``common.run_layer``).

    Under an ``act_hints.SeqSplit`` (one stage: the sharded serve step)
    this rank runs positions [lo, hi) of the residual stream: global
    positions for RoPE and the causal mask, K/V gathered over the
    group for attention and the cache, the last prompt token's state
    from the rank that holds it."""
    params = common.fetch_top(params, fetch)
    if first:
        x = common.embedding_lookup(params["embed"], inp)
        if frontend is not None:
            x = torch.cat([frontend.to(x.dtype), x], dim=1)
    else:
        x = inp
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    split = act_hints.seq_split()
    if split is not None:
        x, positions = x[:, split.lo:split.hi], positions[:, split.lo:split.hi]
    layers = _stage_layers(cfg, params, cache["scan"].k.shape[0], first)

    def layer(p, x):
        return _layer(cfg, p, x, positions=positions, serving=True)
    for p, c in zip(layers, _stage_caches(cache), strict=True):
        x, (k, v), _ = common.run_layer(layer, p, x, fetch=fetch)
        _prefill_write(cfg, c, k, v, prompt_len)
    if not last:
        return x, cache
    last_pos = (torch.full((b,), s - 1, device=x.device)
                if prompt_len is None else prompt_len.long() - 1)
    if split is not None:
        x_last = split.pick(x, last_pos)
    elif prompt_len is None:
        x_last = x[:, -1:]
    else:
        idx = last_pos[:, None, None].expand(b, 1, x.shape[-1])
        x_last = torch.gather(x, 1, idx)
    return _head_logits(cfg, params, x_last), cache


@torch.no_grad()
def stage_decode(cfg, params, inp, cache, *, first: bool, last: bool,
                 fetch=None):
    """One decode step through one stage's layers, the cache advanced in
    place.

    ``inp``: (B, 1) token ids when ``first`` else (B, 1, D) activations.
    Returns ``(out, cache)``: (B, V) logits when ``last`` else (B, 1, D)
    activations. RoPE positions come from the per-slot cache lengths,
    so slots at different depths each get their own phase, and every
    stage derives them from its own cache (a chain's stages advance in
    lockstep). ``fetch``: see ``stage_prefill``."""
    params = common.fetch_top(params, fetch)
    x = common.embedding_lookup(params["embed"], inp) if first else inp
    scan = cache["scan"]
    positions = scan.length[0][:, None].clone()      # (B, 1)
    rolling = cfg.sliding_window is not None
    layers = _stage_layers(cfg, params, scan.k.shape[0], first)

    def layer(p, x, c):
        return _layer(cfg, p, x, positions=positions, layer_cache=c,
                      rolling=rolling, serving=True)
    for p, c in zip(layers, _stage_caches(cache), strict=True):
        x, _, _ = common.run_layer(layer, p, x, c, fetch=fetch)
    if not last:
        return x, cache
    return _head_logits(cfg, params, x), cache


def prefill(cfg, params, tokens, cache, *, prompt_len=None, frontend=None,
            fetch=None):
    """Run the (right-padded) prompt, fill ``cache`` in place ->
    (last-token logits (B, V), cache). The one-stage case of
    ``stage_prefill``."""
    return stage_prefill(cfg, params, tokens, cache, first=True, last=True,
                         prompt_len=prompt_len, frontend=frontend,
                         fetch=fetch)


@torch.no_grad()
def prefill_extend(cfg, params, tokens, cache, *, start: int, seg_len: int):
    """Chunked prefill: run one right-padded prompt SEGMENT at absolute
    offset ``start`` against an already-partial cache, written in place.

    ``tokens``: (B, S) segment; ``start``: absolute position of
    tokens[:, 0], equal to the cache's per-slot ``length`` (the write
    cursor); ``seg_len``: true segment length (<= S). Returns
    (last-token logits (B, V), cache with ``length = start + seg_len``
    in every layer's cache, the dense prefix's too).

    Each layer writes the segment's K/V through ``cache_update`` and
    every query row attends over the whole live prefix (the paged
    cache's dense view, earlier segments included), so chaining
    segments reproduces a single-shot ``prefill``. Full-causal only: an
    SWA ring has no stable absolute cells to resume into."""
    if cfg.sliding_window is not None:
        raise ValueError("prefill_extend is full-causal only (SWA "
                         "rings roll; resume offsets are undefined)")
    start, seg_len = int(start), int(seg_len)
    x = common.embedding_lookup(params["embed"], tokens)
    b, s, _ = x.shape
    hd = _head_dim(cfg)
    positions = (start + torch.arange(s, device=x.device))[None].expand(b, s)
    caches = _stage_caches(cache)
    layers = _stage_layers(cfg, params, cache["scan"].k.shape[0], True)
    for p, c in zip(layers, caches, strict=True):
        q, k, v = _qkv(cfg, p, x, positions)
        attn.cache_update(c, k, v)                   # writes at length
        view = attn.paged_view(c) if isinstance(c, attn.PagedKVCache) \
            else c
        o = attn.attention(q, view.k, view.v, causal=True, q_offset=start,
                           block_q=cfg.block_q)
        x = x + o.reshape(b, s, cfg.n_heads * hd) @ p["wo"]
        x = x + _ffn_block(cfg, p, x, serving=True)[0]
    # cache_update advanced length by the PADDED width; the true cursor
    # is start + seg_len
    for c in attn.kv_leaves(cache):
        c.length.fill_(start + seg_len)
    return _head_logits(cfg, params, x[:, seg_len - 1:seg_len]), cache


def decode_step(cfg, params, token, cache, *, fetch=None):
    """One decode step. token: (B, 1) -> (logits (B, V), cache), the
    cache advanced in place. The one-stage case of ``stage_decode``."""
    return stage_decode(cfg, params, token, cache, first=True, last=True,
                        fetch=fetch)
