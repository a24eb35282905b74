"""Encoder-decoder transformer (port of ``repro.models.encdec``; the
seamless-m4t-medium backbone).

The speech / text frontend is a stub, as in the JAX package: the
encoder takes precomputed frame embeddings (B, L_src, d_model); the
decoder is a causal transformer with per-layer cross-attention into the
encoder memory. Encoder and decoder layers stay stacked (leading ``L``
dim) in the JAX package's layout and run as a Python loop.

Serving: ``prefill`` encodes the source, computes each decoder layer's
cross K/V once into the cache and runs the BOS token; ``decode_step``
runs one decoder token against the self cache (written in place) and
the static cross cache. Both decode attentions go through
``attention.decode_attention``: on CUDA the flash-decode kernel runs
twice per decoder layer per step, once against the self cache and once
against the cross cache as a ``KVCache(cross_k, cross_v, src_len)``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.sharding import act_hints


def _hd(cfg) -> int:
    return cfg.head_dim or cfg.d_model // cfg.n_heads


def n_enc_dec(cfg) -> tuple[int, int]:
    """(encoder layers, decoder layers): ``n_layers`` split evenly, the
    odd one to the decoder."""
    n_enc = cfg.n_layers // 2
    return n_enc, cfg.n_layers - n_enc


def _alloc_attn(cfg, empty, lead) -> dict:
    d, hq = cfg.d_model, cfg.n_heads * _hd(cfg)
    hk = cfg.n_kv_heads * _hd(cfg)
    return {"wq": empty(*lead, d, hq), "wk": empty(*lead, d, hk),
            "wv": empty(*lead, d, hk), "wo": empty(*lead, hq, d)}


def _alloc_mlp(cfg, empty, lead) -> dict:
    d = cfg.d_model
    return {"gate": empty(*lead, d, cfg.d_ff), "up": empty(*lead, d, cfg.d_ff),
            "down": empty(*lead, cfg.d_ff, d)}


def alloc_encdec(cfg, *, device="cuda") -> dict:
    """The parameter tree of ``init_encdec`` (``repro``'s layout, the
    config's dtype), unfilled but for the norm gains (ones): ``embed``,
    ``ln_enc``, ``ln_dec``, ``lm_head`` and the stacked ``enc`` layers
    (``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``) and ``dec`` layers
    (``ln_self``, ``self``, ``ln_cross``, ``cross``, ``ln_mlp``,
    ``mlp``). On the ``meta`` device it is the abstract tree."""
    def empty(*shape):
        return torch.empty(shape, dtype=cfg.torch_dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.torch_dtype, device=device)

    d = cfg.d_model
    n_enc, n_dec = n_enc_dec(cfg)
    return {
        "embed": empty(cfg.padded_vocab, d), "ln_enc": ones(d),
        "ln_dec": ones(d), "lm_head": empty(d, cfg.padded_vocab),
        "enc": {"ln_attn": ones(n_enc, d),
                "attn": _alloc_attn(cfg, empty, (n_enc,)),
                "ln_mlp": ones(n_enc, d),
                "mlp": _alloc_mlp(cfg, empty, (n_enc,))},
        "dec": {"ln_self": ones(n_dec, d),
                "self": _alloc_attn(cfg, empty, (n_dec,)),
                "ln_cross": ones(n_dec, d),
                "cross": _alloc_attn(cfg, empty, (n_dec,)),
                "ln_mlp": ones(n_dec, d),
                "mlp": _alloc_mlp(cfg, empty, (n_dec,))}}


def encdec_axes(cfg) -> dict:
    """The logical-axes twin of ``alloc_encdec`` (the reference's
    ``init_encdec`` axes)."""
    att = {"wq": ("embed", "heads"), "wk": ("embed", "heads"),
           "wv": ("embed", "heads"), "wo": ("heads", "embed")}
    mlp = {"gate": ("embed", "ff"), "up": ("embed", "ff"),
           "down": ("ff", "embed")}
    e = ("embed",)
    return {"embed": ("vocab", "embed"), "ln_enc": e, "ln_dec": e,
            "lm_head": ("embed", "vocab"),
            "enc": common.stack_layer_axes(
                {"ln_attn": e, "attn": att, "ln_mlp": e, "mlp": mlp}),
            "dec": common.stack_layer_axes(
                {"ln_self": e, "self": att, "ln_cross": e, "cross": att,
                 "ln_mlp": e, "mlp": mlp})}


def _init_attn(cfg, p: dict, generator: torch.Generator) -> None:
    for name in ("wq", "wk", "wv"):
        common.normal_(p[name], generator)
    common.normal_(p["wo"], generator,
                   scale=(cfg.n_heads * _hd(cfg)) ** -0.5)


def _init_mlp(cfg, p: dict, generator: torch.Generator) -> None:
    common.normal_(p["gate"], generator)
    common.normal_(p["up"], generator)
    common.normal_(p["down"], generator, scale=cfg.d_ff ** -0.5)


def init_encdec(cfg, generator: torch.Generator, *, device="cuda") -> dict:
    """Random parameters with ``repro``'s scales and layout, each
    layer's tensors drawn in fp32 on ``device`` and cast into their
    slice of the stack."""
    params = alloc_encdec(cfg, device=device)
    common.normal_(params["embed"], generator, scale=0.02)
    common.normal_(params["lm_head"], generator)
    n_enc, n_dec = n_enc_dec(cfg)
    for i in range(n_enc):
        p = common.tree_index(params["enc"], i)
        _init_attn(cfg, p["attn"], generator)
        _init_mlp(cfg, p["mlp"], generator)
    for i in range(n_dec):
        p = common.tree_index(params["dec"], i)
        _init_attn(cfg, p["self"], generator)
        _init_attn(cfg, p["cross"], generator)
        _init_mlp(cfg, p["mlp"], generator)
    return params


# -- blocks -------------------------------------------------------------------


def _mha(cfg, p, xq, xkv, *, causal, positions=None, split=None):
    """Prefill attention of ``xq`` into ``xkv`` (RoPE on both when
    ``positions`` is given: self-attention), through
    ``attention.attention``. ``split``: self-attention over positions
    [lo, hi) of a sequence split, K/V gathered over its group."""
    hd = _hd(cfg)
    b, sq, _ = xq.shape
    sk = xkv.shape[1]
    q = (xq @ p["wq"]).reshape(b, sq, cfg.n_heads, hd)
    k = (xkv @ p["wk"]).reshape(b, sk, cfg.n_kv_heads, hd)
    v = (xkv @ p["wv"]).reshape(b, sk, cfg.n_kv_heads, hd)
    if positions is not None:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    q_offset = 0
    if split is not None:
        k, v = split.gather_seq(k), split.gather_seq(v)
        q_offset = split.lo
    o = attn.attention(q, k, v, causal=causal, q_offset=q_offset,
                       block_q=cfg.block_q)
    return o.reshape(b, sq, -1) @ p["wo"]


def _mlp(cfg, p, x):
    h = common.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return common.swiglu(h, p["mlp"]["gate"], p["mlp"]["up"],
                         p["mlp"]["down"])


def _positions(b: int, s: int, device, lo: int = 0) -> torch.Tensor:
    return torch.arange(lo, lo + s, device=device)[None].expand(b, s)


def _enc_block(cfg, p, x, pos, split=None):
    h = common.rms_norm(x, p["ln_attn"], cfg.norm_eps)
    x = x + _mha(cfg, p["attn"], h, h, causal=False, positions=pos,
                 split=split)
    return x + _mlp(cfg, p, x)


def encode(cfg, params, src_embeds, *, remat=False, fetch=None,
           split=None):
    """Encoder forward: non-causal self-attention with RoPE over the
    frame embeddings -> memory (B, L_src, d_model), final-normed.
    ``remat`` / ``fetch`` per layer: ``common.run_layer``. ``split``
    (an ``act_hints.SeqSplit`` over the source): this rank runs source
    positions [lo, hi) and returns their memory, attending over the
    gathered K/V."""
    x = src_embeds.to(cfg.torch_dtype)
    lo = 0
    if split is not None:
        x, lo = x[:, split.lo:split.hi], split.lo
    pos = _positions(x.shape[0], x.shape[1], x.device, lo)
    n_enc, _ = n_enc_dec(cfg)

    def layer(p, x):
        return _enc_block(cfg, p, x, pos, split)
    for i in range(n_enc):
        x = common.run_layer(layer, common.tree_index(params["enc"], i), x,
                             remat=remat, fetch=fetch)
    return common.rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _dec_block(cfg, p, x, memory, pos, split=None):
    h = common.rms_norm(x, p["ln_self"], cfg.norm_eps)
    x = x + _mha(cfg, p["self"], h, h, causal=True, positions=pos,
                 split=split)
    h = common.rms_norm(x, p["ln_cross"], cfg.norm_eps)
    x = x + _mha(cfg, p["cross"], h, memory, causal=False)
    return x + _mlp(cfg, p, x)


def decoder_logits(cfg, params, memory, tokens, *, remat=False, fetch=None,
                   split=None):
    """Teacher-forced decoder over ``tokens`` (B, S) against the encoder
    ``memory`` -> logits (B, S, V). Plain PyTorch, differentiable;
    ``remat`` / ``fetch`` per layer: ``common.run_layer``. ``split``
    (an ``act_hints.SeqSplit`` over the target): this rank runs target
    positions [lo, hi) (causal self-attention over the gathered K/V at
    ``q_offset`` lo) against the whole ``memory``, and returns their
    logits."""
    lo = 0
    if split is not None:
        tokens, lo = tokens[:, split.lo:split.hi], split.lo
    x = common.embedding_lookup(params["embed"], tokens)
    pos = _positions(x.shape[0], x.shape[1], x.device, lo)
    _, n_dec = n_enc_dec(cfg)

    def layer(p, x, memory):
        return _dec_block(cfg, p, x, memory, pos, split)
    for i in range(n_dec):
        x = common.run_layer(layer, common.tree_index(params["dec"], i), x,
                             memory, remat=remat, fetch=fetch)
    x = common.rms_norm(x, params["ln_dec"], cfg.norm_eps)
    return x @ params["lm_head"]


def loss_fn(cfg, params, batch, *, remat=False, fetch=None):
    """(loss, metrics) of one batch {"src_embeds", "tokens", "targets",
    "mask"}: cross-entropy + max-z over the decoder's logits. ``remat``
    checkpoints each layer; ``fetch`` maps each layer's weights (and the
    top-level ones) before use (``common.run_layer``).

    Under an ``act_hints.SeqSplit`` (the sequence-parallel train step)
    the split is laid over the source for the encoder and over the
    target for the decoder, each rank running its positions of both.
    Cross-attention needs the whole memory: the encoder's output is
    gathered once (``gather_seq``, whose backward sums the group's
    gradients of it), and every decoder layer projects its cross K/V
    from it. Under an ``act_hints.LossSplit`` the loss and metrics are
    this rank's terms of the worker's."""
    params = common.fetch_top(params, fetch)
    split = act_hints.seq_split()
    src, targets, mask = batch["src_embeds"], batch["targets"], \
        batch.get("mask")
    src_split = tgt_split = None
    if split is not None:
        src_split = split.over(src.shape[1])
        tgt_split = split.over(targets.shape[1])
        targets = targets[:, tgt_split.lo:tgt_split.hi]
        mask = None if mask is None else mask[:, tgt_split.lo:tgt_split.hi]
    memory = encode(cfg, params, src, remat=remat, fetch=fetch,
                    split=src_split)
    if src_split is not None:
        memory = src_split.gather_seq(memory)
    logits = decoder_logits(cfg, params, memory, batch["tokens"],
                            remat=remat, fetch=fetch, split=tgt_split)
    return common.cross_entropy_max_z(logits, targets, mask,
                                      z_weight=cfg.max_z_weight,
                                      split=act_hints.loss_split())


# -- serving ------------------------------------------------------------------


def init_cache(cfg, batch_size: int, max_len: int, src_len: int, *,
               device="cuda") -> dict:
    """The serving cache, ``repro``'s tree: ``{"self": KVCache stacked
    (n_dec, B, max_len, Hk, dh), "cross_k", "cross_v": (n_dec, B,
    src_len, Hk, dh), "src_len": (B,) int32}``."""
    hd = _hd(cfg)
    _, n_dec = n_enc_dec(cfg)

    def zeros():
        return torch.zeros((n_dec, batch_size, src_len, cfg.n_kv_heads, hd),
                           dtype=cfg.torch_dtype, device=device)
    return {"self": attn.KVCache.init(n_dec, batch_size, max_len,
                                      cfg.n_kv_heads, hd,
                                      dtype=cfg.torch_dtype, device=device),
            "cross_k": zeros(), "cross_v": zeros(),
            "src_len": torch.zeros((batch_size,), dtype=torch.int32,
                                   device=device)}


@torch.no_grad()
def prefill(cfg, params, src_embeds, bos_token, cache, *, fetch=None):
    """Encode the source, write every decoder layer's cross K/V into the
    (fresh) cache in place, then run the BOS token (B, 1) -> (logits
    (B, V), cache). The source may be shorter than the cache's cross
    capacity: ``src_len`` masks the rest. ``fetch`` maps each layer's
    weights (and the top-level ones) before use.

    A sharded cache (``train.step.local_cache``) holds the cross K/V as
    its ``cross_layout`` says: by heads, the rank's heads of every
    cell; by sequence, its cells [off, off + S_blk) of the capacity,
    those below the source's length projected (none on a rank whose
    cells all lie past it). Under an ``act_hints.SeqSplit`` (the serve
    step's prefill when the KV heads do not divide 'model') the rank
    encodes its source positions (``even_bounds``, which need not be
    its cells) and the memory is gathered once, forward only; the BOS
    token runs whole on every rank."""
    params = common.fetch_top(params, fetch)
    split = act_hints.seq_split()
    src_split = None if split is None else split.over(src_embeds.shape[1])
    memory = encode(cfg, params, src_embeds, fetch=fetch, split=src_split)
    if src_split is not None:
        memory = src_split.gather_seq(memory)
    hd = _hd(cfg)
    b, sl, _ = memory.shape
    lay = cache.get("cross_layout")
    blk = cache["cross_k"].shape[2]
    off, cap = (lay.seq if lay is not None and lay.seq is not None
                else (0, blk))
    if sl > cap:
        raise ValueError(f"encdec prefill: source of {sl} frames vs cross "
                         f"cache capacity {cap}")
    lo, hi = min(off, sl), min(off + blk, sl)     # this block's live cells
    mem = memory[:, lo:hi]
    _, n_dec = n_enc_dec(cfg)
    for i in range(n_dec):
        p = common.tree_index(params["dec"], i)["cross"]
        if fetch is not None:
            p = fetch({"wk": p["wk"], "wv": p["wv"]}, ("cross",))
        for name in ("k", "v"):
            kv = (mem @ p["w" + name]).reshape(b, hi - lo, cfg.n_kv_heads,
                                               hd)
            cache["cross_" + name][i, :, lo - off:hi - off] = (
                kv if lay is None else lay.own_heads(kv))
    cache["src_len"].fill_(sl)
    return _decode(cfg, params, bos_token, cache, fetch)


@torch.no_grad()
def decode_step(cfg, params, token, cache, *, fetch=None):
    """One decoder token (B, 1) -> (logits (B, V), cache): the self
    cache advanced in place, the cross cache read. RoPE positions come
    from the per-slot self-cache lengths. ``fetch``: see ``prefill``."""
    return _decode(cfg, common.fetch_top(params, fetch), token, cache, fetch)


def _decode(cfg, params, token, cache, fetch):
    """``decode_step`` with the top-level weights already fetched. The
    cross cache is a ``KVCache`` over (cross_k, cross_v, src_len), laid
    out as the tree's ``cross_layout`` says on a sharded cache: by
    sequence, its own cells of its own capacity, which is not the self
    cache's (min(ENCDEC_SELF_CACHE, seq_len) cells against seq_len)."""
    x = common.embedding_lookup(params["embed"], token)
    b = x.shape[0]
    hd = _hd(cfg)
    pos = cache["self"].length[0][:, None].clone()
    lay = cache.get("cross_layout")
    _, n_dec = n_enc_dec(cfg)
    for i in range(n_dec):
        p = common.fetched(common.tree_index(params["dec"], i), fetch)
        ps, pc = p["self"], p["cross"]
        h = common.rms_norm(x, p["ln_self"], cfg.norm_eps)
        q = (h @ ps["wq"]).reshape(b, 1, cfg.n_heads, hd)
        k = (h @ ps["wk"]).reshape(b, 1, cfg.n_kv_heads, hd)
        v = (h @ ps["wv"]).reshape(b, 1, cfg.n_kv_heads, hd)
        q = common.apply_rope(q, pos, cfg.rope_theta)
        k = common.apply_rope(k, pos, cfg.rope_theta)
        sc = cache["self"].layer(i)
        attn.cache_update(sc, k, v)
        o = attn.decode_attention(q, sc)
        x = x + o.reshape(b, 1, -1) @ ps["wo"]
        h = common.rms_norm(x, p["ln_cross"], cfg.norm_eps)
        q = (h @ pc["wq"]).reshape(b, 1, cfg.n_heads, hd)
        ck, cv = cache["cross_k"][i], cache["cross_v"][i]
        cross = (attn.KVCache(ck, cv, cache["src_len"]) if lay is None
                 else lay.view(ck, cv, cache["src_len"]))
        o = attn.decode_attention(q, cross)
        x = x + o.reshape(b, 1, -1) @ pc["wo"]
        x = x + _mlp(cfg, p, x)
    x = common.rms_norm(x, params["ln_dec"], cfg.norm_eps)
    return (x @ params["lm_head"])[:, 0], cache
