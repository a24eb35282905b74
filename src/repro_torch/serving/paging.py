"""Paged KV serving tier (port of ``repro.serving.paging``): one global
block pool, per-slot block tables, copy-on-write shared prefixes.

The dense ``ContinuousEngine`` gives every slot a ``max_len``-wide KV
cache, so device memory, not compute, caps concurrency, and co-batched
requests re-prefill a shared system prompt. This tier keeps ONE
physical block pool per layer (``attention.PagedKVCache``) and reaches
it through per-slot block tables:

* **BlockPool** (host): free-list allocation with refcounts over the
  physical block ids. Block 0 is the reserved trash block (writes of
  done or overflowing slots land there). A request's worst-case need is
  allocated AT ADMISSION, so pool pressure is a typed
  ``BlockPoolExhaustedError`` on admission, never a corruption or a
  mid-decode stall.

* **Content-addressed prefix sharing**: full prompt blocks are chain-
  hashed (sha256 over (parent digest, block tokens)), so requests with a
  common prefix map the SAME physical blocks, refcounted. A full-prompt
  hit also reuses the registered last-token logits and admits with no
  prefill at all. The index holds no refs: a block's entries go when
  its last user retires.

* **Copy-on-write**: a partially filled tail block adopted from the
  index is written at its first decode step, so admission reserves a
  fork target and ``_before_chunk`` copies the block just in time, only
  if it is still shared. Full blocks are never written after prefill.

* **Chunked prefill**: a partial prefix hit, or a prompt longer than one
  dense prefill (``capacity_blocks`` past ``max_len``), resumes through
  ``model.prefill_extend`` segments that write straight into the pool.

Unlike the JAX package, every device write (pagination of a scratch
prefill, the fork, the extend segments, the tables) goes IN PLACE into
the shared pool tensors. The dense engine stays the bit-identity foil:
on the card the paged kernel is bitwise equal to the dense one, so
greedy tokens equal ``ContinuousEngine(batch_admit=False)``'s.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.serving.engine import ContinuousEngine, Request

_HASH_ROOT = b"repro-paged-prefix-v1"


class BlockPoolExhaustedError(RuntimeError):
    """No free KV blocks for an allocation. Raised at ADMISSION (the
    failed request goes back to the queue head); decode never
    allocates, so an admitted request always runs to its budget."""


class BlockPool:
    """Host-side free-list allocator with refcounts over the physical
    KV block pool. Block 0 (trash) is never handed out.

    ``on_pressure(pool, short)`` is the eviction hook: called before an
    allocation fails, it may release blocks; the allocation is checked
    again after it. ``on_free(bid, tags)`` fires when a block leaves the
    pool's ownership (the engine drops the block's prefix-index entries).

    With ``retain_tagged=True`` a tagged (prefix-indexed) block whose
    refcount reaches zero is PARKED on the ``cold`` LRU list instead of
    freed: its KV and index entries survive, so a later request with the
    same prefix revives it through :meth:`incref`. ``evict`` and
    ``evict_cold`` turn cold blocks back into free ones (and only then
    fire ``on_free``)."""

    def __init__(self, n_blocks: int, *, on_pressure=None, on_free=None,
                 retain_tagged: bool = False):
        if n_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (one is trash)")
        self.n_blocks = n_blocks
        self.free: deque[int] = deque(range(1, n_blocks))
        self.ref = np.zeros((n_blocks,), np.int32)
        self.tags: dict[int, list] = {}
        self.on_pressure = on_pressure
        self.on_free = on_free
        self.retain_tagged = retain_tagged
        # zero-ref tagged blocks, oldest parked first (LRU order)
        self.cold: OrderedDict[int, None] = OrderedDict()
        self.stats = {"allocs": 0, "frees": 0, "peak_used": 0,
                      "exhausted": 0, "parked": 0, "revived": 0,
                      "evicted": 0}

    @property
    def used(self) -> int:
        return self.n_blocks - 1 - len(self.free)

    @property
    def cold_count(self) -> int:
        return len(self.cold)

    def alloc(self, n: int) -> list[int]:
        if n <= 0:
            return []
        if len(self.free) < n and self.on_pressure is not None:
            self.on_pressure(self, n - len(self.free))
        if len(self.free) < n:
            self.stats["exhausted"] += 1
            raise BlockPoolExhaustedError(
                f"need {n} KV blocks, {len(self.free)} free "
                f"(pool size {self.n_blocks - 1})")
        ids = [self.free.popleft() for _ in range(n)]
        for b in ids:
            self.ref[b] = 1
        self.stats["allocs"] += n
        self.stats["peak_used"] = max(self.stats["peak_used"], self.used)
        return ids

    def incref(self, bid: int) -> None:
        if not self.ref[bid] and bid in self.cold:
            # a prefix match on a parked block revives it
            del self.cold[bid]
            self.ref[bid] = 1
            self.stats["revived"] += 1
            return
        if self.ref[bid] <= 0:
            raise ValueError(f"incref on free block {bid}")
        self.ref[bid] += 1

    def decref(self, bid: int) -> bool:
        """Drop one ref. At zero the block frees (firing ``on_free``
        with its tags), unless ``retain_tagged`` and it carries tags:
        then it parks on the cold LRU list with its index entries.
        Returns True if freed."""
        if self.ref[bid] <= 0:
            raise ValueError(f"decref on free block {bid}")
        self.ref[bid] -= 1
        if self.ref[bid]:
            return False
        if self.retain_tagged and self.tags.get(bid):
            self.cold[bid] = None        # most recently parked at the end
            self.stats["parked"] += 1
            return False
        self._free_block(bid)
        return True

    def _free_block(self, bid: int) -> None:
        tags = self.tags.pop(bid, [])
        if self.on_free is not None:
            self.on_free(bid, tags)
        self.free.append(bid)
        self.stats["frees"] += 1

    def evict(self, bid: int) -> None:
        """Free one cold block: drops its index entries (``on_free``)
        and returns it to the free list."""
        if bid not in self.cold:
            raise ValueError(f"evict on non-cold block {bid}")
        del self.cold[bid]
        self._free_block(bid)
        self.stats["evicted"] += 1

    def evict_cold(self, n: int) -> int:
        """Evict up to ``n`` cold blocks, oldest parked first (LRU);
        returns the number evicted (the ``on_pressure`` policy when
        prefix retention is on)."""
        evicted = 0
        while evicted < n and self.cold:
            bid, _ = self.cold.popitem(last=False)
            self._free_block(bid)
            self.stats["evicted"] += 1
            evicted += 1
        return evicted

    def tag(self, bid: int, item) -> None:
        self.tags.setdefault(bid, []).append(item)


class PrefixIndex:
    """Content-addressed registry of shared prefix blocks.

    ``blocks``: chain digest of prompt blocks [0, i] -> physical block
    holding block i's KV. ``tails``: digest of (last full-block chain
    digest, tail tokens) -> (tail block id or None, last-token logits
    row), the full-prompt entry that lets an exact repeat admit with no
    prefill. Entries hold NO refs; they go when their block is freed."""

    def __init__(self):
        self.blocks: dict[bytes, int] = {}
        self.tails: dict[bytes, tuple[int | None, torch.Tensor]] = {}

    def clear(self) -> None:
        self.blocks.clear()
        self.tails.clear()

    def drop(self, bid: int, tags: list) -> None:
        """``BlockPool.on_free``: block ``bid`` left the pool, so its
        ``tags`` (("block" | "tail", digest)) leave the index."""
        for kind, key in tags:
            (self.blocks if kind == "block" else self.tails).pop(key, None)


def _evict_cold(pool: BlockPool, short: int) -> None:
    """``BlockPool.on_pressure`` with prefix retention: evict the
    coldest parked blocks."""
    pool.evict_cold(short)


def chain_digests(prompt: np.ndarray, blk: int) -> tuple[list[bytes],
                                                         bytes]:
    """sha256 chain over the prompt's full blocks, plus the tail
    digest. ``digests[i]`` commits to tokens [0, (i+1)*blk), so a match
    guarantees the indexed block holds exactly the KV a fresh prefill of
    this prompt would write there (full-causal attention: a block's
    content depends only on its prefix). Same bytes as the JAX
    package's."""
    p = np.ascontiguousarray(np.asarray(prompt, np.int32))
    h = _HASH_ROOT
    digests = []
    f = len(p) // blk
    for i in range(f):
        h = hashlib.sha256(h + p[i * blk:(i + 1) * blk].tobytes()).digest()
        digests.append(h)
    tail = hashlib.sha256(h + b"|tail|" + p[f * blk:].tobytes()).digest()
    return digests, tail


def build_paged_cache(model, slots: int, shape, *, block_size: int,
                      n_blocks: int | None = None,
                      capacity_blocks: int | None = None,
                      rolling: bool = False):
    """The paged counterpart of ``model.init_cache(slots, shape)``:
    every ``KVCache`` of the model's cache tree replaced by a
    ``PagedKVCache`` over a shared physical pool, on the model's device
    (the template is the ``meta``-device cache, so the dense cache is
    never allocated). Returns (cache, nb, n_blocks); see
    ``paged_cache_from_template``."""
    template = model.init_cache(slots, shape, device="meta")
    return paged_cache_from_template(
        template, slots=slots, block_size=block_size, n_blocks=n_blocks,
        capacity_blocks=capacity_blocks, rolling=rolling,
        device=model.device)


def paged_cache_from_template(template, *, slots: int, block_size: int,
                              n_blocks: int | None = None,
                              capacity_blocks: int | None = None,
                              rolling: bool = False, device="cuda"):
    """Core of :func:`build_paged_cache` over a cache template (a
    ``{"scan": KVCache, "prefix": [...]}`` tree, best on the ``meta``
    device); the swarm stage servers build theirs from
    ``StageDef.init_cache``. A stacked (L, B, S, Hk, dh) leaf becomes a
    pool k/v (L, n_blocks, block_size, Hk, dh) in the leaf's dtype, one
    (slots, nb) table of -1 that every layer shares and (L, slots)
    lengths; an unstacked leaf the same without L.

    Every leaf (the stack and the dense prefix layers') shares the ONE
    table tensor, as the JAX package shares one table across its KV
    leaves: a slot's blocks hold the same cells in every layer.

    nb = the cache width (``max_len``, or the SWA ring) over
    ``block_size``, widened to ``capacity_blocks`` for full-causal
    models. Returns (cache, nb, n_blocks); ``n_blocks=None`` sizes the
    pool to the dense capacity (slots * nb blocks + trash)."""
    widths = set()
    for leaf in attn.kv_leaves(template):
        s_max = leaf.k.shape[-3]
        if s_max % block_size:
            raise ValueError(f"block_size {block_size} must divide the "
                             f"cache width {s_max} (max_len / SWA ring)")
        nb = s_max // block_size
        if capacity_blocks is not None and not rolling:
            nb = max(nb, capacity_blocks)
        widths.add(nb)
    if len(widths) > 1:
        raise ValueError(f"non-uniform paged table widths {widths}")
    nb = widths.pop() if widths else 0
    if n_blocks is None:
        n_blocks = slots * nb + 1 if nb else 2
    table = torch.full((slots, nb), -1, dtype=torch.int32, device=device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        lead = tuple(node.k.shape[:-4])          # (L,) when stacked
        hk, dh = node.k.shape[-2:]
        pool = torch.zeros(lead + (n_blocks, block_size, hk, dh),
                           dtype=node.k.dtype, device=device)
        return attn.PagedKVCache(
            pool, torch.zeros_like(pool), table,
            torch.zeros(lead + (slots,), dtype=torch.int32, device=device))

    return conv(template), nb, n_blocks


def scatter_row(pool_c: attn.PagedKVCache, dense_c: attn.KVCache,
                row: torch.Tensor, blk: int) -> None:
    """Copy a dense B = 1 cache leaf (stacked or not; a fresh scratch
    prefill) into the pool blocks ``row`` maps ((nb,) block ids, -1 =
    unmapped), in place; cells past the allocation, or of a scratch
    wider than the table, go to trash block 0."""
    nb = row.shape[0]
    w = min(dense_c.k.shape[-3], nb * blk)
    cells = torch.arange(w, device=row.device)
    phys = row.long()[cells // blk].clamp_min(0)
    off = cells % blk
    pool_c.k[..., phys, off, :, :] = \
        dense_c.k[..., 0, :w, :, :].to(pool_c.k.dtype)
    pool_c.v[..., phys, off, :, :] = \
        dense_c.v[..., 0, :w, :, :].to(pool_c.v.dtype)


class PagedEngine(ContinuousEngine):
    """``ContinuousEngine`` with the per-slot dense cache swapped for
    the paged block pool. The decode loop is UNCHANGED (``cache_update``
    and ``decode_attention`` dispatch on the paged cache, the latter to
    the paged flash-decode kernel); admission allocates blocks, matches
    content-addressed prefixes, and fills the slot from a paginated
    scratch prefill, an extend-resumed suffix, or (full hit) nothing at
    all."""
    kind = "paged"

    def __init__(self, model, params, *, block_size: int = 16,
                 pool_blocks: int | None = None,
                 capacity_blocks: int | None = None,
                 cache_prefixes: bool = False,
                 prefill_chunk: int | None = None, **kw):
        family = getattr(model.cfg, "family", "")
        if family == "encdec":
            raise ValueError("paged serving unsupported for family "
                             "'encdec' (cross caches page per source, "
                             "not per token)")
        kw.pop("overlap_admission", None)   # admission is host-stateful
        kw.pop("batch_admit", None)         # per request (block alloc)
        self.rolling = model.cfg.sliding_window is not None
        self.blk = int(block_size)
        self._pool_args = (pool_blocks, capacity_blocks)
        super().__init__(model, params, batch_admit=False, **kw)
        self.capacity = self.nb * self.blk
        # cache_prefixes: park zero-ref prefix-tagged blocks on the
        # pool's cold LRU list so repeat prompts hit even after every
        # sharer retired; admission under pressure evicts the coldest
        # instead of raising. Off by default: the dense-foil invariant
        # is refcount-zero-frees-exactly-at-retire.
        self.cache_prefixes = bool(cache_prefixes)
        self.prefix = PrefixIndex() if (
            not self.rolling and family in ("dense", "moe", "vlm")) else None
        # the pool's hooks hold the index, not the engine: no reference
        # cycle keeps a retired engine's weights alive until a gc pass
        self.pool = BlockPool(
            self.n_blocks,
            on_free=None if self.prefix is None else self.prefix.drop,
            retain_tagged=self.cache_prefixes,
            on_pressure=_evict_cold if self.cache_prefixes else None)
        self._extend = None if self.rolling else model.prefill_extend
        self.prefill_chunk = int(prefill_chunk or self.max_len)
        self._tables = np.full((self.slots, self.nb), -1, np.int32)
        self._tbl_dirty = False
        self._slot_blocks: list[list[int]] = [[] for _ in
                                              range(self.slots)]
        # (table index to check, reserved fork target) per slot
        self._cow_pending: list[tuple[int, int] | None] = \
            [None] * self.slots
        self.stats.update(prefix_lookups=0, prefix_hits=0,
                          prefix_hit_tokens=0, prompt_tokens=0,
                          cow_forks=0, paged_extends=0, admit_deferred=0)

    def _make_cache(self):
        pool_blocks, capacity_blocks = self._pool_args
        cache, self.nb, self.n_blocks = build_paged_cache(
            self.model, self.slots, self.shape, block_size=self.blk,
            n_blocks=pool_blocks, capacity_blocks=capacity_blocks,
            rolling=self.rolling)
        return cache

    # -- device-side pieces (in place on the shared pool) ---------------------

    def _set_len(self, slot: int, n: int) -> None:
        for leaf in attn.kv_leaves(self.cache):
            leaf.length[..., slot] = n

    def _paginate(self, sub, row: list[int], slot: int) -> None:
        """Copy a dense batch-1 scratch prefill (width S) into the pool
        blocks ``row`` maps, in every layer (the dense prefix's too), and
        take its lengths. Cells past the row (scratch wider than the
        allocation) go to the trash block."""
        r = torch.full((self.nb,), -1, dtype=torch.int32)
        r[:len(row)] = torch.tensor(row, dtype=torch.int32)
        r = r.to(self.device)
        for pool, small in zip(attn.kv_leaves(self.cache),
                               attn.kv_leaves(sub), strict=True):
            scatter_row(pool, small, r, self.blk)
            pool.length[..., slot] = small.length[..., 0]

    def _fork(self, src: int, dst: int) -> None:
        """Copy physical block ``src`` into ``dst`` in every layer."""
        for pool in attn.kv_leaves(self.cache):
            pool.k[..., dst, :, :, :] = pool.k[..., src, :, :, :]
            pool.v[..., dst, :, :, :] = pool.v[..., src, :, :, :]

    def _extend_slot(self, tokens: np.ndarray, slot: int, start: int,
                     seg_len: int) -> torch.Tensor:
        """One chunked-prefill segment for ``slot``: ``prefill_extend``
        on the slot's batch-1 view of the cache (each leaf's pool
        tensors themselves, the slot's table row and its lengths, all
        views), so the segment's K/V and the new lengths land in
        place."""
        def view(pool):
            return attn.PagedKVCache(pool.k, pool.v,
                                     pool.table[slot:slot + 1],
                                     pool.length[..., slot:slot + 1])
        logits, _ = self._extend(
            self.params, {"tokens": torch.from_numpy(tokens).to(self.device),
                          "start": start, "seg_len": seg_len},
            {"scan": view(self.cache["scan"]),
             "prefix": [view(c) for c in self.cache["prefix"]]})
        return logits

    # -- host-side admission --------------------------------------------------

    def _budget(self, req: Request) -> int:
        if self.rolling:
            return super()._budget(req)
        return max(1, min(req.max_new_tokens,
                          self.capacity - len(req.prompt)))

    def _admit(self) -> None:
        """Fill free slots one request at a time (block allocation is
        per request). On pool exhaustion the request is back at the
        queue head: if anything is still decoding, its retire will free
        blocks, so admission defers to the next chunk boundary, keeping
        FIFO order. Only a request that cannot fit an EMPTY pool raises
        the typed error to the caller."""
        free = [s for s in range(self.slots) if self.active[s] is None]
        while free and self.queue:
            req = self.queue.popleft()
            try:
                self._admit_one(req, free.pop(0))
            except BlockPoolExhaustedError:
                if not any(r is not None for r in self.active):
                    raise
                self.stats["admit_deferred"] += 1
                return

    def _match_prefix(self, prompt: np.ndarray):
        """Greedy longest content-addressed match: full blocks along the
        chain hash, then the full-prompt tail entry. Returns (shared
        block ids (ref'd), matched prefix length H, cached last-token
        logits or None, tail block adopted?, digests, tail digest)."""
        digests, tail_digest = chain_digests(prompt, self.blk)
        if self.prefix is None:
            return [], 0, None, False, digests, tail_digest
        self.stats["prefix_lookups"] += 1
        plen = len(prompt)
        ids: list[int] = []
        for d in digests:
            bid = self.prefix.blocks.get(d)
            if bid is None:
                break
            ids.append(bid)
        m = len(ids)
        hit = m * self.blk
        hit_logits, tail_shared = None, False
        if m == len(digests):
            ent = self.prefix.tails.get(tail_digest)
            if ent is not None:
                tail_bid, hit_logits = ent
                if tail_bid is not None:
                    ids.append(tail_bid)
                    tail_shared = True
                hit = plen
        if hit >= plen and hit_logits is None and m:
            # whole-prompt block coverage but no cached logits: the last
            # block must run again, and a shared block cannot be the
            # write target, so drop it from the match
            ids.pop()
            m -= 1
            hit = m * self.blk
        for bid in ids:
            self.pool.incref(bid)
        if hit:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_hit_tokens"] += hit
        return ids, hit, hit_logits, tail_shared, digests, tail_digest

    def _register_prefix(self, prompt: np.ndarray, row: list[int],
                         matched: int, digests: list[bytes],
                         tail_digest: bytes, logits) -> None:
        if self.prefix is None:
            return
        for i in range(matched, len(digests)):
            if digests[i] not in self.prefix.blocks:
                self.prefix.blocks[digests[i]] = row[i]
                self.pool.tag(row[i], ("block", digests[i]))
        if tail_digest not in self.prefix.tails:
            f = len(digests)
            tail_bid = row[f] if len(prompt) % self.blk else None
            self.prefix.tails[tail_digest] = (tail_bid, logits)
            if tail_bid is not None:
                self.pool.tag(tail_bid, ("tail", tail_digest))

    def _admit_one(self, req: Request, slot: int) -> None:
        plen = len(req.prompt)
        if self.rolling:
            # ring semantics: the scratch prefill keeps the last window
            # whatever the prompt length, exactly like the dense foil
            limit = self.max_len
        elif self._extend is not None:
            limit = self.capacity
        else:
            limit = min(self.max_len, self.capacity)
        if not 1 <= plen <= limit:
            raise ValueError(f"prompt length {plen} vs paged capacity "
                             f"{limit}")
        prompt = np.asarray(req.prompt, np.int32)
        self.stats["prompt_tokens"] += plen
        budget = self._budget(req)
        if self.rolling:
            n_total = self.nb          # the whole ring, private
            hit, matched_len, hit_lg, tail_shared = [], 0, None, False
            digests, tail_digest = [], b""
        else:
            cells = min(plen + budget, self.capacity)
            n_total = -(-cells // self.blk)
            (hit, matched_len, hit_lg, tail_shared,
             digests, tail_digest) = self._match_prefix(prompt)
        fork = tail_shared and plen % self.blk
        need = (n_total - len(hit)) + (1 if fork else 0)
        try:
            fresh = self.pool.alloc(need)
        except BlockPoolExhaustedError:
            for bid in hit:
                self.pool.decref(bid)
            self.queue.appendleft(req)
            raise
        spare = fresh.pop() if fork else None
        row = hit + fresh
        self._tables[slot, :] = -1
        self._tables[slot, :len(row)] = row
        self._tbl_dirty = True
        self._slot_blocks[slot] = row + ([spare] if spare is not None
                                         else [])
        self._cow_pending[slot] = (plen // self.blk, spare) \
            if spare is not None else None
        self._push_tables()
        matched = len(hit) - (1 if tail_shared else 0)

        if matched_len == plen:              # full hit: no prefill
            logits = hit_lg
            self._set_len(slot, plen)
        elif matched_len == 0:
            # dense scratch prefill of the leading window (the exact
            # bucketed batch-1 call the dense foil makes), paginated
            w0 = min(plen, self.max_len)
            toks = np.full((1, self._padded_len(w0)), self.pad_id, np.int32)
            toks[0, :w0] = prompt[:w0]
            self.stats["prefills"] += 1
            logits, sub = self._prefill(toks, np.array([w0], np.int32))
            self._paginate(sub, row, slot)
            if w0 < plen:                    # prompt exceeds one bucket
                logits = self._extend_to(slot, prompt, w0)
        else:                                # partial hit: resume at H
            self._set_len(slot, matched_len)
            logits = self._extend_to(slot, prompt, matched_len)
        self._admit_state(req, slot, logits)
        if not self.rolling:
            self._register_prefix(prompt, row, matched, digests,
                                  tail_digest, logits)

    def _extend_to(self, slot: int, prompt: np.ndarray,
                   start: int) -> torch.Tensor:
        """Run ``prefill_extend`` segments until the whole prompt is in
        the cache; returns the last-token logits."""
        if self._extend is None:
            raise ValueError("prefix resume and long prompts need "
                             "model.prefill_extend (full-causal models)")
        plen = len(prompt)
        logits = None
        pos = start
        while pos < plen:
            w = min(self.prefill_chunk, plen - pos)
            toks = np.full((1, self._padded_len(w)), self.pad_id, np.int32)
            toks[0, :w] = prompt[pos:pos + w]
            self.stats["prefill_widths"].add(toks.shape[1])
            self.stats["paged_extends"] += 1
            logits = self._extend_slot(toks, slot, pos, w)
            pos += w
        return logits

    # -- scheduler seams ------------------------------------------------------

    def _push_tables(self) -> None:
        if not self._tbl_dirty:
            return
        # one table, shared by every KV leaf
        self.cache["scan"].table.copy_(torch.from_numpy(self._tables))
        self._tbl_dirty = False

    def _before_chunk(self) -> None:
        """Copy-on-write fork point: a slot that adopted a shared,
        partially filled tail block appends to it at its first decode
        write, so fork the physical block now if it is still shared, or
        else adopt it in place."""
        for slot, req in enumerate(self.active):
            pend = self._cow_pending[slot]
            if req is None or pend is None:
                continue
            bi, spare = pend
            self._cow_pending[slot] = None
            bid = int(self._tables[slot, bi])
            if self.pool.ref[bid] > 1:
                self._fork(bid, spare)
                self._tables[slot, bi] = spare
                self._tbl_dirty = True
                self._slot_blocks[slot].remove(bid)
                self.pool.decref(bid)
                self.stats["cow_forks"] += 1
            else:
                # every other sharer retired: sole owner, append in
                # place; the reserved fork target goes back
                self._slot_blocks[slot].remove(spare)
                self.pool.decref(spare)
        self._push_tables()

    def _release_slot(self, slot: int) -> None:
        """Retire: drop the slot's refs. Blocks (and their index
        entries) free exactly when their LAST sharer retires; the
        slot's table row goes to -1, so its writes while it idles
        through a chunk land in trash block 0."""
        for bid in self._slot_blocks[slot]:
            self.pool.decref(bid)
        self._slot_blocks[slot] = []
        self._cow_pending[slot] = None
        self._tables[slot, :] = -1
        self._tbl_dirty = True

    def flush_prefix_cache(self) -> None:
        """Invalidate all content-addressed prefix state (cached KV and
        logits depend on the parameters: call it after a params swap).
        Live requests keep their blocks; parked cold blocks free."""
        self.pool.evict_cold(len(self.pool.cold))
        if self.prefix is not None:
            self.prefix.clear()
        self.pool.tags.clear()

    def perf_summary(self) -> dict:
        s = super().perf_summary()
        prompt_toks = self.stats["prompt_tokens"]
        s.update(
            block_size=self.blk,
            pool_blocks=self.pool.n_blocks - 1,
            blocks_peak=self.pool.stats["peak_used"],
            prefix_hits=self.stats["prefix_hits"],
            prefix_hit_tokens=self.stats["prefix_hit_tokens"],
            prefix_hit_rate=(self.stats["prefix_hit_tokens"]
                             / prompt_toks if prompt_toks else 0.0),
            cow_forks=self.stats["cow_forks"],
            paged_extends=self.stats["paged_extends"],
            cold_blocks=self.pool.cold_count,
            blocks_revived=self.pool.stats["revived"],
            blocks_evicted=self.pool.stats["evicted"])
        return s
