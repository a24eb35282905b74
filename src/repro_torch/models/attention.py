"""Attention (port of ``repro.models.attention``): GQA prefill
attention, the per-slot KV cache (dense, or paged through a block
table), its write cursor and the single-token decode attention.

K/V stay (B, S, Hk, dh) and Q is viewed as (B, T, Hk, G, dh), as in the
JAX package: KV is never expanded to Hq heads. Unlike the JAX package,
``cache_update`` writes in place; callers that reuse a dense cache must
hand in a fresh one (see ``serving.engine``), and a paged cache's pool
is shared by every slot, so its writes land where the slot's table
says (``serving.paging`` keeps the tables). A ``ShardedKVCache`` is one
rank's block of a cache laid over ranks by heads or by sequence (the
sharded serve step, its ``KVLayout``): its writes and decode attention
do that rank's part and gather the rest.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    """Per-slot KV cache. One layer's: k/v (B, S_max, Hk, dh), length
    (B,). Stacked over layers (``init``, ``transformer.init_cache``):
    k/v (L, B, S_max, Hk, dh), length (L, B); ``layer(l)`` is a view."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor      # int32 — tokens written PER SLOT (absolute)

    @classmethod
    def init(cls, n_layers: int, batch: int, max_len: int, n_kv: int,
             head_dim: int, *, dtype=torch.bfloat16, device="cuda"
             ) -> "KVCache":
        z = torch.zeros((n_layers, batch, max_len, n_kv, head_dim),
                        dtype=dtype, device=device)
        return cls(z, torch.zeros_like(z),
                   torch.zeros((n_layers, batch), dtype=torch.int32,
                               device=device))

    def layer(self, i: int) -> "KVCache":
        return dataclasses.replace(self, k=self.k[i], v=self.v[i],
                                   length=self.length[i])


@dataclasses.dataclass(frozen=True)
class KVLayout:
    """Which block of a KV cache laid over the 'model' axis a rank holds
    (``train.step.local_cache``). One of:

      * ``heads = (lo, hi, n)``: kv heads [lo, hi) of n. Decode runs the
        flash-decode kernel at this rank's heads (query heads [lo G,
        hi G)) and gathers the heads' outputs;
      * ``seq = (off, s_ring)``: cells [off, off + S_blk) of a cache (or
        SWA ring) of s_ring cells. Decode writes the new token's K/V on
        the rank that holds its cell, runs the block variant on every
        rank (``block_length`` live cells, no window: a ring is never
        wider than its window) and merges the blocks' partials.

    ``all_gather(t)`` is the group's forward all-gather (a list in rank
    order). A cache tree that keeps a cache's tensors apart (an
    enc-dec's ``cross_k`` / ``cross_v``, read with ``src_len``) keeps
    its layout beside them."""
    heads: tuple | None = None
    seq: tuple | None = None
    all_gather: Callable | None = None

    def own_heads(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (..., Hk, dh) cut to this block's kv heads (all of them
        when laid by sequence)."""
        if self.heads is None:
            return t
        return t[..., self.heads[0]:self.heads[1], :]

    def view(self, k: torch.Tensor, v: torch.Tensor,
             length: torch.Tensor) -> "ShardedKVCache":
        """The block (k, v) with the slots' global ``length``."""
        return ShardedKVCache(k, v, length, self)


@dataclasses.dataclass
class ShardedKVCache(KVCache):
    """One rank's block of a KV cache laid over the 'model' axis
    (``train.step.build_serve_step``), as its ``layout`` says: k/v hold
    the block, ``length`` the slots' global lengths (every rank keeps
    them). Its writes and decode attention do the rank's part and
    gather the rest. ``layer(i)`` keeps the layout."""
    layout: KVLayout

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t`` laid out as the whole cache
        (..., S, Hk, dh)."""
        if self.layout.seq is None:
            return self.layout.own_heads(t)
        off = self.layout.seq[0]
        return t[..., off:off + self.k.shape[-3], :, :]

    def write(self, fn, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """``fn(cache, k, v)``, a write into a dense cache, on this block:
        heads laid, the block and the rank's heads of k/v; seq laid, a
        whole-cache copy holding this block, cut back after."""
        if self.layout.seq is None:
            fn(KVCache(self.k, self.v, self.length), self.own(k_new),
               self.own(v_new))
            return
        shape = (tuple(self.k.shape[:-3]) + (self.layout.seq[1],)
                 + tuple(self.k.shape[-2:]))
        full = KVCache(self.k.new_zeros(shape), self.v.new_zeros(shape),
                       self.length)
        self.own(full.k).copy_(self.k)
        self.own(full.v).copy_(self.v)
        fn(full, k_new, v_new)
        self.k.copy_(self.own(full.k))
        self.v.copy_(self.own(full.v))

    def update_token(self, k_new, v_new, rolling: bool) -> None:
        """A decode step's write (one token) on a seq-laid block: the
        dense ``cache_update``'s cell (the ring cursor, or the length
        clamped to the last cell), written only where this block holds
        it; every rank advances the lengths."""
        off, s_ring = self.layout.seq
        blk = self.k.shape[-3]
        cell = self.length % s_ring if rolling else self.length
        loc = cell.clamp(0, s_ring - 1).long() - off
        mine = ((loc >= 0) & (loc < blk))[:, None, None]
        rows = torch.arange(self.k.shape[0], device=loc.device)
        idx = loc.clamp(0, blk - 1)
        for buf, new in ((self.k, k_new), (self.v, v_new)):
            buf[rows, idx] = torch.where(mine, new[:, 0].to(buf.dtype),
                                         buf[rows, idx])
        self.length += 1

    def attend(self, q: torch.Tensor, window: int | None) -> torch.Tensor:
        from repro_torch.kernels import flash_decode
        lay = self.layout
        if lay.seq is None:
            lo, hi, n = lay.heads
            g = q.shape[2] // n
            o = flash_decode.flash_decode(
                q[:, :, lo * g:hi * g].contiguous(), self.k, self.v,
                self.length, window=window)
            return torch.cat(lay.all_gather(o), dim=2)
        off, s_ring = lay.seq
        out, lse = flash_decode.flash_decode_partial(
            q, self.k, self.v,
            block_length(self.length, off, self.k.shape[-3], s_ring))
        return flash_decode.merge_partials(lay.all_gather(out),
                                           lay.all_gather(lse))


def block_length(length: torch.Tensor, off: int, s_blk: int,
                 s_ring: int) -> torch.Tensor:
    """Live cells of the block [off, off + s_blk) of a cache of s_ring
    cells, as a prefix of the block: clamp(min(length, s_ring) - off,
    0, s_blk). Exact for a full-causal cache and for an SWA ring of
    min(max_len, window) cells (``transformer.init_cache``): a ring is
    never wider than its window, so its live cells are exactly the
    cells below min(length, s_ring)."""
    return (length.clamp(max=s_ring) - off).clamp(0, s_blk).to(torch.int32)


@dataclasses.dataclass
class PagedKVCache:
    """Block-table KV cache: one physical block pool shared by all
    slots, indexed per slot through a block table.

    Virtual cell ``c`` of slot ``b`` lives at physical cell
    ``(table[b, c // blk], c % blk)``. Physical block 0 is a reserved
    TRASH block, never mapped by a table, so writes past a slot's
    allocation (done slots padding out a decode chunk, pad tails of a
    prefill segment) land harmlessly; ``-1`` entries mean "unmapped"
    and read and write the trash block. Allocation and refcounts are
    host-side (``serving.paging.BlockPool``).

    One layer's: k/v (N_blocks, blk, Hk, dh), table (B, nb), length
    (B,). Stacked (``serving.paging.build_paged_cache``): k/v (L,
    N_blocks, blk, Hk, dh), length (L, B) and ONE (B, nb) table that
    every layer shares (the JAX package broadcasts it to (L, B, nb));
    ``layer(l)`` returns views."""
    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor       # int32 block ids, -1 = unmapped
    length: torch.Tensor      # int32 — tokens written PER SLOT (absolute)

    def layer(self, i: int) -> "PagedKVCache":
        return PagedKVCache(self.k[i], self.v[i], self.table, self.length[i])

    @property
    def block_size(self) -> int:
        return self.k.shape[-3]

    @property
    def s_max(self) -> int:
        """Virtual per-slot capacity in cells."""
        return self.table.shape[-1] * self.k.shape[-3]


def kv_leaves(cache: dict) -> list:
    """The KV caches of a model's cache tree: for a transformer's
    ``{"scan": stacked, "prefix": [unstacked, ...]}`` the stack first,
    then the dense prefix layers'; for an SSM / hybrid's ``{"ssm",
    "kv"}`` the shared attention's stacked cache, or none for a pure
    SSM. Index a leaf's slot as ``k[..., slot, :, :, :]`` and
    ``length[..., slot]``: that holds for a stacked and an unstacked
    leaf alike."""
    if "kv" in cache:
        return [] if cache["kv"] is None else [cache["kv"]]
    return [cache["scan"]] + list(cache["prefix"])


def state_leaves(cache: dict) -> list:
    """The per-slot dense leaves of a cache tree that are not KV: an SSM
    / hybrid's stacked state and conv rings (slot axis 1: ``t[:,
    slot]``); none for a transformer. They stay dense in a paged
    cache."""
    return list(cache["ssm"]) if "ssm" in cache else []


def map_cache(cache: dict, kv_fn, state_fn) -> dict:
    """The cache tree with every KV leaf replaced by ``kv_fn(leaf)`` and
    every state leaf (``state_leaves``) by ``state_fn(tensor)``, its
    structure kept."""
    if "kv" in cache:
        ssm = cache["ssm"]
        return {"ssm": type(ssm)(*(state_fn(t) for t in ssm)),
                "kv": None if cache["kv"] is None else kv_fn(cache["kv"])}
    return {"scan": kv_fn(cache["scan"]),
            "prefix": [kv_fn(c) for c in cache["prefix"]]}


def paged_view(cache: PagedKVCache) -> KVCache:
    """Gather one layer's pool through the table into the dense
    per-slot view (B, nb * blk, Hk, dh): cell for cell the dense cache
    of the same virtual capacity (unmapped blocks read the trash block,
    and those cells are masked by ``length`` downstream)."""
    tbl = cache.table.clamp_min(0).long()             # (B, nb)
    b = tbl.shape[0]
    k = cache.k[tbl].reshape(b, -1, *cache.k.shape[2:])
    v = cache.v[tbl].reshape(b, -1, *cache.v.shape[2:])
    return KVCache(k, v, cache.length)


def paged_cache_update(cache: PagedKVCache, k_new: torch.Tensor,
                       v_new: torch.Tensor, *,
                       rolling: bool = False) -> PagedKVCache:
    """Append S_new tokens through the block table, IN PLACE.

    The dense ``cache_update``'s per-slot write cursor (start at
    ``length``; SWA wraps mod the virtual ring size), scattered to
    (table[slot, cell // blk], cell % blk). Cells past the virtual
    capacity or on an unmapped (-1) entry go to trash block 0 (no clamp
    of the start, unlike the dense cache); duplicate trash cells are
    the only collisions and are never read. Returns the same (mutated)
    cache."""
    blk = cache.block_size
    nb = cache.table.shape[1]
    s_max = nb * blk
    s_new = k_new.shape[1]
    start = cache.length % s_max if rolling else cache.length      # (B,)
    cells = start.long()[:, None] + torch.arange(s_new,
                                                 device=start.device)
    if rolling:
        cells = cells % s_max
    live = cells < s_max
    bi = (cells // blk).clamp(0, nb - 1)
    phys = torch.gather(cache.table, 1, bi).long()                 # (B, S)
    phys = torch.where(live & (phys >= 0), phys, 0)
    off = torch.where(live, cells % blk, 0)
    cache.k[phys, off] = k_new.to(cache.k.dtype)
    cache.v[phys, off] = v_new.to(cache.v.dtype)
    cache.length += s_new
    return cache


def _grouped(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, T, Hq, dh) -> (B, T, Hk, G, dh)."""
    b, t, hq, dh = q.shape
    return q.reshape(b, t, n_kv, hq // n_kv, dh)


def _sdpa_block(qg, k, v, mask):
    """One (q-block x kv-range) grouped attention, fp32 softmax.

    qg: (B, T, Hk, G, dh); k, v: (B, S, Hk, dh); mask: (T, S) bool.
    Returns (B, T, Hk, G, dh)."""
    scale = qg.shape[-1] ** -0.5
    s = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scale
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              q_offset: int = 0, block_q: int = 512) -> torch.Tensor:
    """Chunked GQA attention (the prefill path).

    q: (B, Sq, Hq, dh); k/v: (B, Sk, Hk, dh) with Hq % Hk == 0.
    ``q_offset``: absolute position of q[0] relative to k[0];
    ``window``: SWA width (None = full causal). Query blocks of
    ``block_q`` rows attend to the key range their mask can reach, so
    the (Sq, Sk) score matrix never materializes."""
    b, sq, hq, dh = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qg = _grouped(q, hk)
    kpos_all = torch.arange(sk, device=q.device)
    outs = []
    for lo in range(0, sq, block_q):
        hi = min(sq, lo + block_q)
        k_lo = 0 if window is None else max(0, q_offset + lo - window + 1)
        k_hi = min(sk, q_offset + hi) if causal else sk
        qpos = q_offset + torch.arange(lo, hi, device=q.device)[:, None]
        kpos = kpos_all[None, k_lo:k_hi]
        mask = torch.ones((hi - lo, k_hi - k_lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        outs.append(_sdpa_block(qg[:, lo:hi], k[:, k_lo:k_hi],
                                v[:, k_lo:k_hi], mask))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, sq, hq, dh).to(q.dtype)


def decode_valid_mask(length: torch.Tensor, s_max: int,
                      window: int | None) -> torch.Tensor:
    """(B,) per-slot lengths -> (B, S_max) bool mask of live cache cells.

    Full-causal: cell s is live while s < length. SWA: the cache is a
    rolling ring of size s_max; recover each cell's absolute position
    from the write cursor and keep the last ``window`` positions."""
    length = length[:, None].to(torch.int64)                  # (B, 1)
    cell = torch.arange(s_max, device=length.device)[None, :]  # (1, S)
    if window is None:
        return cell < length
    rem = length % s_max
    abs_pos = torch.where(
        length > s_max,
        torch.where(cell < rem, length - rem + cell,
                    length - rem - s_max + cell),
        cell)
    return (abs_pos < length) & (abs_pos >= length - window)


def decode_attention(q: torch.Tensor, cache: KVCache | PagedKVCache, *,
                     window: int | None = None) -> torch.Tensor:
    """Single-token grouped attention against the per-slot cache.

    q: (B, 1, Hq, dh); ``cache.length`` is (B,), so every slot masks its
    own live prefix. This is the JAX package's ``impl="pallas"`` path:
    on a CUDA tensor it launches the hand-written flash-decode kernel
    (its paged variant for a paged cache, which reads the pool through
    the table), on a CPU tensor it runs that kernel's plain PyTorch
    version."""
    from repro_torch.kernels import flash_decode
    if isinstance(cache, ShardedKVCache):
        return cache.attend(q, window)
    if isinstance(cache, PagedKVCache):
        return flash_decode.flash_decode_paged(
            q, cache.k, cache.v, cache.table, cache.length, window=window)
    return flash_decode.flash_decode(q, cache.k, cache.v, cache.length,
                                     window=window)


def cache_update(cache: KVCache | PagedKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, *, rolling: bool = False):
    """Append S_new tokens (prefill write or one decode step) IN PLACE.

    Each slot writes at its own ``length`` (its write cursor), so a
    freshly prefilled slot can sit next to slots deep into decode; the
    start clamps to ``S_max - S_new`` as JAX's dynamic_update_slice does.
    Rolling mode wraps the cursor into a window-sized ring. Paged
    caches dispatch to ``paged_cache_update``. Returns the same
    (mutated) cache."""
    if isinstance(cache, PagedKVCache):
        return paged_cache_update(cache, k_new, v_new, rolling=rolling)
    if isinstance(cache, ShardedKVCache):
        if cache.layout.seq is not None and k_new.shape[1] == 1:
            cache.update_token(k_new, v_new, rolling)
        else:
            cache.write(lambda c, k, v: cache_update(c, k, v,
                                                     rolling=rolling),
                        k_new, v_new)
        return cache
    b, s_max = cache.k.shape[0], cache.k.shape[1]
    s_new = k_new.shape[1]
    start = cache.length % s_max if rolling else cache.length      # (B,)
    start = start.clamp(0, s_max - s_new).long()
    rows = torch.arange(b, device=start.device)[:, None]
    cells = start[:, None] + torch.arange(s_new, device=start.device)
    cache.k[rows, cells] = k_new.to(cache.k.dtype)
    cache.v[rows, cells] = v_new.to(cache.v.dtype)
    cache.length += s_new
    return cache
