"""Attention (port of ``repro.models.attention``): GQA prefill
attention, the per-slot KV cache (dense, or paged through a block
table), its write cursor and the single-token decode attention.

K/V stay (B, S, Hk, dh) and Q is viewed as (B, T, Hk, G, dh), as in the
JAX package: KV is never expanded to Hq heads. Unlike the JAX package,
``cache_update`` writes in place; callers that reuse a dense cache must
hand in a fresh one (see ``serving.engine``), and a paged cache's pool
is shared by every slot, so its writes land where the slot's table
says (``serving.paging`` keeps the tables).
"""
from __future__ import annotations

import dataclasses

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
        return KVCache(self.k[i], self.v[i], self.length[i])


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
    """The KV caches of a model's cache tree ``{"scan": stacked,
    "prefix": [unstacked, ...]}``: the stack first, then the dense
    prefix layers'. Index a leaf's slot as ``k[..., slot, :, :, :]`` and
    ``length[..., slot]``: that holds for a stacked and an unstacked
    leaf alike."""
    return [cache["scan"]] + list(cache["prefix"])


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
