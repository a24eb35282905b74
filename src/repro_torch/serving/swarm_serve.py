"""Fault-tolerant swarm inference (port of ``repro.serving.swarm_serve``):
pipeline-stage serving over unreliable peers, with failover re-prefill
(paper §2.4.2's failure model applied to SERVING: peers are partial,
unreliable replicas, and a request must survive any one of them dying
mid-decode).

A model is split into K contiguous-layer stages
(``registry.make_stages``); each ``StageServer`` peer holds one or more
stages (parameter views + per-request KV cache) on its device and speaks
the same framed-TCP JSON-op protocol as ``ChunkPeer``. It IS a
``ChunkPeer`` subclass, so checkpoint chunks, gossip polls and stage
RPCs ride one port, one connection pool and one typed-error family. The
wire protocol is the JAX package's byte for byte, so a JAX peer and a
port peer serve each other:

  * ``{"op": "stages"}`` -> ``{"stages": [...], "k_stages": K}``;
  * ``{"op": "prefill_stage", "sid", "rid", "install", "plen",
    "meta"}`` + one tensor frame (tokens (1, S) int32 on stage 0,
    activations (1, S, D) elsewhere) -> ``{"ok", "meta"}`` + one tensor
    frame (activations, or (1, V) logits on the last stage). ``plen``
    is the true prompt length; the router right-pads prompts to the
    SAME power-of-two buckets the single-host engine uses, so a staged
    chain reproduces the engine's prefill widths, and its logits, bit
    for bit. ``install`` False runs the forward STATELESSLY (the JAX
    package's failover replay through healthy upstream stages); True
    (re)creates the request's stage cache;
  * ``{"op": "decode_stage", "sid", "rid", "seq", "meta"}`` + tensor
    frame ((1, 1) token / (1, 1, D) activation) -> appends exactly one
    position to the request's cache. ``seq`` is the stage's expected
    pre-decode cache length: a duplicate (``seq == len - 1``, e.g. a
    retry after the response was lost on a stale pooled conn) replays
    the saved output WITHOUT re-appending, so decode is idempotent on
    the wire even though the cache append is not;
  * ``{"op": "adopt_stage", "sid", "peers"}`` -> the server
    swarm-fetches the published stage weights (weight distribution is
    ``swarm_fetch``) into its own chunk store and starts serving the
    stage;
  * ``{"op": "release", "rid"}`` -> drops the request's state.

A tensor frame is the raw C-order bytes of the array (bf16 as its 16-bit
patterns), its shape and dtype name in the JSON header's ``meta``.

Stage possession is gossiped as synthetic inventory ids (``stage:NNNN``)
merged into the server's chunk digest/inventory, so ``ChunkGossip``
needs no changes and ``gossip.holders("stage:0002")`` answers "who can
serve stage 2 right now".

The client-side ``SwarmRouter`` plans a chain of one holder per stage
from gossip possession and streams each request through it. Failure
handling (crash = ``PeerClosedError``/``ConnectionError``, stall =
``PeerTimeoutError``, corruption = ``ChecksumError``, all typed, all
``FetchError``):

  * during PREFILL the router still holds the activations it was
    sending, so failover is: mark the peer dead, pick a surviving
    holder, resend. No replay.
  * during DECODE at stage j, stages 0..j-1 already committed the
    in-flight token (their caches are one position ahead) and the dead
    stage's KV state is gone. Recovery replays the request's token
    prefix (prompt + tokens emitted so far: BOUNDED replay) through
    stages 0..j, the new holder of stage j included, the way the
    uninterrupted run computed it: the prompt's prefill
    (``install=True``), then one ``decode_stage`` per emitted token.
    Stages j+1.. receive the last-position activation via one ordinary
    ``decode_stage`` (appending the exact position they were missing).
    The rebuilt caches and the logits that come out are bitwise those
    of an uninterrupted run, so in-flight requests complete with its
    greedy tokens. (The JAX package rebuilds with one pass-through
    prefill over the whole prefix instead; see ``_replay`` for why the
    port does not.)
  * a failure DURING recovery moves the failure point (another holder
    dies -> the replay restarts / recovery recurses one stage further
    down); every failure consumes one unit of the per-request replay
    budget, so a flapping swarm fails typed (``ReplayBudgetError``)
    instead of looping.
  * a stage with no surviving holder raises ``StageUnservableError``
    (a ``FetchError``): the chain fails typed, never hangs.

Fault injection reuses the ``ChunkPeer`` knobs (``crash_after``,
``stall_chunks``/``stall_s``, ``corrupt_after``), counted in
``served_chunks`` across chunk AND stage responses.

Unlike the JAX package, stage caches are written in place: a dense
prefill gets a fresh ``init_stage_cache``, and a paged decode runs on a
B = 1 view that shares the stage pool's storage, so its writes land in
the pool. The first stage also holds the dense prefix layers' caches
(``cache["prefix"]``: DeepSeek-MoE's first layer), dense or in its
pool. Decode attention is ``attention.decode_attention``: on a CUDA
device the flash-decode kernel (dense caches) or its paged variant
(paged pools), on the CPU their plain versions.
"""
from __future__ import annotations

import hashlib
import json
import struct
import threading
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.checkpointing import checkpoint as _ckpt
from repro_torch.checkpointing.p2p import (FetchError, PeerConn, PeerConnPool,
                                           PeerTimeoutError, RetryPolicy,
                                           _recv_frame, _send_frame)
from repro_torch.checkpointing.store import ChunkStore
from repro_torch.checkpointing.swarm import ChunkPeer, swarm_fetch
from repro_torch.models import attention as attn
from repro_torch.models import registry
from repro_torch.serving.engine import bucket_len
from repro_torch.serving.paging import (BlockPool, BlockPoolExhaustedError,
                                        paged_cache_from_template,
                                        scatter_row)

Addr = tuple  # (host, port)


class StageUnservableError(FetchError):
    """No surviving holder can serve a required stage: the chain fails
    typed instead of hanging on a dead peer."""

    def __init__(self, msg: str, sid: int | None = None,
                 failures: dict | None = None):
        super().__init__(msg)
        self.sid = sid
        self.failures = failures or {}


class ReplayBudgetError(StageUnservableError):
    """A request burned its failover/replay budget (flapping swarm)."""


class StageRPCError(FetchError):
    """The peer answered, but with a protocol-level error (unknown
    stage, lost request state, seq mismatch). Treated like a peer
    failure by the router: fail over, re-prefill."""


def stage_chunk_id(sid: int) -> str:
    """The synthetic gossip-inventory id advertising stage possession."""
    return f"stage:{int(sid):04d}"


# -- tensor frames ------------------------------------------------------------


def _encode_arr(arr) -> tuple[bytes, dict]:
    """(raw bytes, ``{"shape", "dtype"}``) of a tensor or numpy array."""
    buf, dtype = _ckpt.leaf_to_bytes(arr)
    return buf, {"shape": list(arr.shape), "dtype": dtype}


def _decode_arr(blob: bytes, meta: dict) -> torch.Tensor:
    """The frame's array as a CPU tensor."""
    return _ckpt.leaf_from_bytes(blob, meta["dtype"], tuple(meta["shape"]))


# -- paged stage KV -----------------------------------------------------------


def _map_caches(fn, tree, *rest):
    """``fn`` over the KV leaves of a stage cache tree (dicts, lists)
    and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: _map_caches(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_caches(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _paged_view(pool_c: attn.PagedKVCache, row: torch.Tensor,
                ln: int) -> attn.PagedKVCache:
    """The B = 1 paged cache one request sees: the stage's shared pool
    tensors (so decode writes land in the pool) with the request's own
    (1, nb) table row and a fresh length tensor at ``ln``."""
    length = torch.full(tuple(pool_c.length.shape[:-1]) + (1,), ln,
                        dtype=torch.int32, device=row.device)
    return attn.PagedKVCache(pool_c.k, pool_c.v, row[None], length)


# -- weight distribution ------------------------------------------------------


def publish_stages(store: ChunkStore, cfg, params, k_stages: int,
                   *, stage_ids: Sequence[int] | None = None) -> list:
    """Chunk each stage's parameter slice into ``store`` under
    ``step == stage id``. Any ``ChunkPeer`` over that store can then
    hand the weights to a joining ``StageServer`` via plain
    ``swarm_fetch(step=sid)``: weight distribution IS the checkpoint
    swarm path (striping, failover, content verification included).
    Chunk ids and manifests equal the JAX package's on the same
    weights."""
    stages = registry.make_stages(cfg, k_stages, params["embed"].device)
    picked = stages if stage_ids is None else \
        [stages[i] for i in stage_ids]
    return [store.save_tree(s.index, s.slice_params(params),
                            extra_meta={"stage": s.index,
                                        "k_stages": k_stages},
                            kind="full")
            for s in picked]


def restore_stage_params(store: ChunkStore, cfg, k_stages: int, sid: int,
                         device="cuda") -> dict:
    """Rebuild one stage's parameter tree on ``device`` from published
    chunks (the structure from ``registry.stage_param_specs``)."""
    manifest = store.load_manifest(sid)
    like = registry.stage_param_specs(cfg, k_stages)[sid]
    flat = {k: store.read_leaf(e).to(device)
            for k, e in manifest["keys"].items()}
    return _ckpt.unflatten_like(like, flat)


# -- server -------------------------------------------------------------------


class StageServer(ChunkPeer):
    """One swarm-serving peer: a ``ChunkPeer`` (chunk store + gossip
    ops) that also serves pipeline stages on ``device``. See the module
    docstring for the wire protocol. Thread-safe: each client
    connection gets a session thread; stage tables and per-request state
    are lock-guarded. The stage functions run under ``torch.no_grad``
    (grad mode is per thread, and every session is a new thread)."""

    def __init__(self, cfg, store: ChunkStore, *, k_stages: int,
                 host: str = "127.0.0.1", port: int = 0,
                 max_len: int = 256, kv_layout: str = "dense",
                 block_size: int = 16, pool_blocks: int | None = None,
                 device="cuda", **fault_knobs):
        self.cfg = cfg
        self.k_stages = int(k_stages)
        self.max_len = int(max_len)
        self.device = torch.device(device)
        # kv_layout="paged": ONE physical block pool per served stage
        # instead of a max_len-wide cache per request: concurrent
        # requests share the pool, each holding only ceil(len/blk)
        # blocks (+1 lazily at each block boundary during decode).
        # Exhaustion is a typed "kv-exhausted" RPC error the router
        # treats like any peer failure: fail over to another holder.
        self.kv_layout = kv_layout
        self.block_size = int(block_size)
        self.pool_blocks = pool_blocks
        if kv_layout == "paged" and cfg.sliding_window is not None:
            raise ValueError("paged kv_layout does not support SWA "
                             "ring caches in the stage tier")
        self._stage_defs = registry.make_stages(cfg, k_stages, self.device)
        self._stages: dict[int, dict] = {}        # sid -> params
        self._reqs: dict[tuple, dict] = {}        # (rid, sid) -> state
        self._pools: dict[int, dict] = {}         # sid -> paged pool
        self._slock = threading.Lock()
        self._plock = threading.Lock()   # serializes pool read-mod-write
        super().__init__(store, host, port, **fault_knobs)

    # -- stage lifecycle -----------------------------------------------------

    def serve_stage(self, sid: int, params: dict) -> None:
        with self._slock:
            self._stages[int(sid)] = params

    def drop_stage(self, sid: int) -> None:
        with self._slock:
            self._stages.pop(int(sid), None)

    def stage_ids(self) -> list[int]:
        with self._slock:
            return sorted(self._stages)

    def adopt_stage(self, sid: int, peers: Sequence[Addr], *,
                    pool: PeerConnPool | None = None,
                    retry: RetryPolicy | None = None,
                    possession: dict | None = None,
                    timeout: float = 20.0) -> dict:
        """Fetch stage ``sid``'s published weights from the swarm into
        the local store (dedup means a rejoin only pulls what's
        missing), rebuild the params on the server's device and start
        serving."""
        stats = swarm_fetch(peers, self.store, step=int(sid),
                            pool=pool, retry=retry,
                            possession=possession, timeout=timeout)
        params = restore_stage_params(self.store, self.cfg,
                                      self.k_stages, int(sid), self.device)
        self.serve_stage(int(sid), params)
        return stats

    # -- gossip possession (chunks + stage tokens) ---------------------------

    def _inventory(self) -> list[str]:
        with self._slock:
            stage_ids = [stage_chunk_id(s) for s in self._stages]
        return sorted(set(self.store.inventory()) | set(stage_ids))

    # -- request compute -----------------------------------------------------

    def _respond_tensor(self, conn, arr) -> None:
        """Ship ``{"ok", "meta"}`` + one tensor frame, applying the
        inherited fault knobs (the response counts as one served
        chunk)."""
        if self.stall_chunks is not None and \
                self.served_chunks >= self.stall_chunks:
            time.sleep(self.stall_s)
        blob, meta = _encode_arr(arr)
        _send_frame(conn, json.dumps({"ok": True,
                                      "meta": meta}).encode())
        if self.corrupt_after is not None and \
                self.served_chunks >= self.corrupt_after:
            # in-transit corruption: a frame whose digest was computed
            # over the TRUE payload but whose bytes got flipped; the
            # receiver's frame check raises ChecksumError, typed
            digest = hashlib.sha256(blob).digest()
            bad = bytes(b ^ 0xFF for b in blob[:64]) + blob[64:]
            conn.sendall(struct.pack("!Q", len(blob)) + digest + bad)
        else:
            _send_frame(conn, blob)
        self.served_chunks += 1

    def _err(self, conn, **payload) -> bool:
        _send_frame(conn, json.dumps(payload).encode())
        return True

    def _paged_pool(self, sid: int) -> dict:
        """Lazily build stage ``sid``'s shared block pool (pool tensors
        + host allocator). Caller holds ``_plock``."""
        ent = self._pools.get(sid)
        if ent is None:
            template = self._stage_defs[sid].init_cache(1, self.max_len,
                                                        device="meta")
            # default: 4 requests' worth of blocks; the pool exists to
            # hold several concurrent requests, not one
            want = self.pool_blocks or \
                4 * (self.max_len // self.block_size) + 1
            cache, nb, n_blocks = paged_cache_from_template(
                template, slots=1, block_size=self.block_size,
                n_blocks=want, device=self.device)
            ent = {"cache": cache, "pool": BlockPool(n_blocks), "nb": nb}
            self._pools[sid] = ent
        return ent

    def _row_arr(self, ent: dict, row: list) -> torch.Tensor:
        r = np.full((ent["nb"],), -1, np.int32)
        r[:len(row)] = row
        return torch.from_numpy(r).to(self.device)

    def _paged_install(self, conn, sid: int, rid, plen: int,
                       new_cache) -> bool:
        """Move a fresh dense stage prefill into pool blocks and record
        the request's (row, length). Returns False on pool exhaustion
        (error already sent)."""
        with self._plock:
            ent = self._paged_pool(sid)
            with self._slock:
                old = self._reqs.get((rid, sid))
            if old is not None:
                for b in old.get("row", ()):
                    ent["pool"].decref(b)
            try:
                row = ent["pool"].alloc(
                    max(1, -(-plen // self.block_size)))
            except BlockPoolExhaustedError as e:
                with self._slock:
                    self._reqs.pop((rid, sid), None)
                self._err(conn, error="kv-exhausted", sid=sid,
                          detail=str(e))
                return False
            rowd = self._row_arr(ent, row)
            _map_caches(lambda c, nc: scatter_row(c, nc, rowd,
                                                  self.block_size),
                        ent["cache"], new_cache)
            with self._slock:
                self._reqs[(rid, sid)] = {"row": row, "len": plen,
                                          "last_out": None}
        return True

    def _paged_decode(self, conn, params, sid: int, rid, x,
                      req: dict) -> bool:
        with self._plock:
            with self._slock:
                state = self._reqs.get((rid, sid))
            if state is None:
                return self._err(conn, error="no-such-request",
                                 rid=rid, sid=sid)
            seq = int(req.get("seq", state["len"]))
            if seq == state["len"] - 1 and \
                    state["last_out"] is not None:
                self._respond_tensor(conn, state["last_out"])
                return True
            if seq != state["len"]:
                return self._err(conn, error="seq-mismatch", rid=rid,
                                 sid=sid, expect=state["len"], got=seq)
            ent = self._paged_pool(sid)
            ln = state["len"]
            bi = ln // self.block_size
            if bi >= ent["nb"]:
                return self._err(conn, error="kv-exhausted", sid=sid,
                                 detail=f"request at capacity "
                                        f"{ent['nb'] * self.block_size}")
            if bi >= len(state["row"]):     # lazy growth at boundary
                try:
                    state["row"] += ent["pool"].alloc(1)
                except BlockPoolExhaustedError as e:
                    return self._err(conn, error="kv-exhausted",
                                     sid=sid, detail=str(e))
            rowd = self._row_arr(ent, state["row"])
            view = _map_caches(lambda c: _paged_view(c, rowd, ln),
                               ent["cache"])
            out, _ = self._stage_defs[sid].decode(params, x, view)
            out_host = out.cpu()
            with self._slock:
                self._reqs[(rid, sid)] = {"row": state["row"],
                                          "len": ln + 1,
                                          "last_out": out_host}
        self._respond_tensor(conn, out_host)
        return True

    def _handle_stage_op(self, conn, req: dict) -> bool:
        blob = _recv_frame(conn)
        sid, rid = int(req["sid"]), req["rid"]
        with self._slock:
            params = self._stages.get(sid)
        if params is None:
            return self._err(conn, error="no-such-stage", sid=sid)
        x = _decode_arr(blob, req["meta"]).to(self.device)
        if req["op"] == "decode_stage" and self.kv_layout == "paged":
            return self._paged_decode(conn, params, sid, rid, x, req)
        stage = self._stage_defs[sid]
        if req["op"] == "prefill_stage":
            cache = stage.init_cache(1, self.max_len)
            plen = int(req.get("plen", x.shape[1]))
            out, new_cache = stage.prefill(
                params, x, cache,
                prompt_len=torch.tensor([plen], dtype=torch.int32,
                                        device=self.device))
            if req.get("install", True):
                if self.kv_layout == "paged":
                    # same dense prefill (bit-identical logits), then
                    # the KV moves into pool blocks
                    if not self._paged_install(conn, sid, rid, plen,
                                               new_cache):
                        return True         # kv-exhausted already sent
                else:
                    with self._slock:
                        self._reqs[(rid, sid)] = {
                            "cache": new_cache, "len": plen,
                            "last_out": None}
            self._respond_tensor(conn, out)
            return True
        with self._slock:                           # decode_stage
            state = self._reqs.get((rid, sid))
        if state is None:
            return self._err(conn, error="no-such-request", rid=rid,
                             sid=sid)
        seq = int(req.get("seq", state["len"]))
        if seq == state["len"] - 1 and state["last_out"] is not None:
            # duplicate delivery (retry after a lost response): replay
            # the saved output, do NOT re-append
            self._respond_tensor(conn, state["last_out"])
            return True
        if seq != state["len"]:
            return self._err(conn, error="seq-mismatch", rid=rid,
                             sid=sid, expect=state["len"], got=seq)
        out, _ = stage.decode(params, x, state["cache"])   # in place
        out_host = out.cpu()
        with self._slock:
            self._reqs[(rid, sid)] = {"cache": state["cache"],
                                      "len": state["len"] + 1,
                                      "last_out": out_host}
        self._respond_tensor(conn, out_host)
        return True

    def release(self, rid: str) -> int:
        with self._plock:
            with self._slock:
                gone = [k for k in self._reqs if k[0] == rid]
                states = [self._reqs.pop(k) for k in gone]
            if self.kv_layout == "paged":
                for (_, sid), st in zip(gone, states):
                    ent = self._pools.get(sid)
                    if ent is not None:
                        for b in st.get("row", ()):
                            ent["pool"].decref(b)
        return len(gone)

    # -- op dispatch ---------------------------------------------------------

    def _handle_op(self, conn, req: dict, pins: list) -> bool:
        op = req.get("op")
        if op in ("prefill_stage", "decode_stage"):
            if self.crash_after is not None and \
                    self.served_chunks >= self.crash_after:
                self.crash()
                return False
            return self._handle_stage_op(conn, req)
        if op == "stages":
            _send_frame(conn, json.dumps(
                {"stages": self.stage_ids(),
                 "k_stages": self.k_stages}).encode())
            return True
        if op == "release":
            _send_frame(conn, json.dumps(
                {"ok": True,
                 "released": self.release(req["rid"])}).encode())
            return True
        if op == "adopt_stage":
            try:
                stats = self.adopt_stage(
                    int(req["sid"]),
                    [tuple(a) for a in req["peers"]],
                    timeout=float(req.get("timeout", 20.0)))
            except (FetchError, OSError) as e:
                return self._err(conn, error="adopt-failed",
                                 detail=str(e))
            _send_frame(conn, json.dumps(
                {"ok": True, "stage": int(req["sid"]),
                 "chunks_fetched": stats["chunks_fetched"]}).encode())
            return True
        if op == "digest":
            # stage possession rides the chunk digest: adding/dropping
            # a stage changes the sha, so gossip pulls the inventory
            # (with its stage:NNNN tokens) exactly when it changed
            ids = self._inventory()
            sha = hashlib.sha256("\n".join(ids).encode()).hexdigest()
            _send_frame(conn, json.dumps(
                {"latest": self.store.latest_step(),
                 "n_chunks": len(ids), "sha": sha,
                 "version": self.store.version}).encode())
            return True
        if op == "inventory":
            _send_frame(conn, json.dumps(
                {"ids": self._inventory()}).encode())
            return True
        if op == "have":
            ids = set(self._inventory())
            _send_frame(conn, json.dumps(
                {"have": [int(d in ids) for d in req["ids"]]}).encode())
            return True
        return super()._handle_op(conn, req, pins)


# -- router -------------------------------------------------------------------


class _Request:
    __slots__ = ("rid", "prompt", "out", "chain", "lens", "replays")

    def __init__(self, rid, prompt, chain, k):
        self.rid = rid
        self.prompt = [int(t) for t in prompt]
        self.out: list[int] = []
        self.chain = chain             # sid -> Addr currently serving
        self.lens = [0] * k            # sid -> committed cache length
        self.replays = 0

    def prefix(self) -> list[int]:
        return self.prompt + self.out


class SwarmRouter:
    """Plans a stage chain from gossip possession and streams requests
    through it, failing over (with bounded-replay re-prefill) when a
    peer crashes, stalls past its deadline, or ships corrupt frames.
    See the module docstring for the recovery state machine. Host code:
    activations and logits arrive as CPU tensors."""

    def __init__(self, k_stages: int, gossip, *, timeout: float = 10.0,
                 pool: PeerConnPool | None = None,
                 max_replays: int = 8, max_len: int = 256,
                 bucket_prompts: bool = True, pad_id: int = 0):
        self.k = int(k_stages)
        self.gossip = gossip
        self.timeout = float(timeout)
        self.pool = pool
        self.max_replays = int(max_replays)
        self.max_len = int(max_len)
        self.bucket_prompts = bucket_prompts
        self.pad_id = int(pad_id)
        self.dead: set[Addr] = set()
        self.stats = {"requests": 0, "decode_steps": 0, "failovers": 0,
                      "replayed_tokens": 0, "recoveries": 0,
                      "recovery_s": 0.0, "fresh_retries": 0}

    # -- planning ------------------------------------------------------------

    def refresh(self) -> None:
        self.gossip.poll_once()

    def holders(self, sid: int) -> list[Addr]:
        return sorted(a for a in
                      self.gossip.holders(stage_chunk_id(sid))
                      if a not in self.dead)

    def _pick(self, sid: int, avoid: Sequence[Addr] = ()) -> Addr:
        hs = [a for a in self.holders(sid) if a not in avoid] \
            or self.holders(sid)
        if not hs:
            raise StageUnservableError(
                f"no surviving holder for stage {sid}", sid=sid)
        return hs[0]

    def plan_chain(self) -> list[Addr]:
        return [self._pick(s) for s in range(self.k)]

    def mark_dead(self, addr: Addr) -> None:
        self.dead.add(tuple(addr))
        if self.pool is not None:
            self.pool.discard_peer(addr)
        self.gossip.remove_peer(addr)

    def revive(self, addr: Addr) -> None:
        """A previously-dead peer rejoined (e.g. after adopt): make it
        plannable again."""
        self.dead.discard(tuple(addr))
        self.gossip.add_peer(addr)

    # -- wire ----------------------------------------------------------------

    def _roundtrip(self, conn: PeerConn, header: dict, arr) -> torch.Tensor:
        blob, meta = _encode_arr(arr)
        conn.send(dict(header, meta=meta))
        conn.send_bytes(blob)
        resp = conn.recv_json()
        if "error" in resp:
            raise StageRPCError(f"peer {conn.addr}: {resp}")
        return _decode_arr(conn.recv_frame(), resp["meta"])

    def _call(self, addr: Addr, header: dict, arr) -> torch.Tensor:
        """One stage RPC. A stalled peer (PeerTimeoutError) fails
        immediately: waiting out the deadline twice buys nothing. A
        closed/reset conn gets ONE fresh-socket retry when pooling is
        on (an idle pooled conn may have been reaped by the server
        between requests); the decode seq numbers make that retry safe
        even though the cache append is not idempotent."""
        try:
            if self.pool is not None:
                with self.pool.lease(addr) as conn:
                    return self._roundtrip(conn, header, arr)
            conn = PeerConn(addr, self.timeout)
            try:
                return self._roundtrip(conn, header, arr)
            finally:
                conn.close()
        except (PeerTimeoutError, StageRPCError):
            raise
        except (FetchError, OSError):
            if self.pool is None:
                raise
            self.stats["fresh_retries"] += 1
            conn = PeerConn(addr, self.timeout)
            try:
                out = self._roundtrip(conn, header, arr)
            except BaseException:
                conn.close()
                raise
            self.pool.release(conn)
            return out

    # -- failure accounting --------------------------------------------------

    def _fail(self, req: _Request, sid: int, addr: Addr, err) -> None:
        self.mark_dead(addr)
        self.stats["failovers"] += 1
        req.replays += 1
        if req.replays > self.max_replays:
            raise ReplayBudgetError(
                f"request {req.rid} exceeded {self.max_replays} "
                f"failovers (last: stage {sid} @ {addr}: {err})",
                sid=sid)
        req.chain[sid] = self._pick(sid, avoid=(addr,))

    # -- request flow --------------------------------------------------------

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 *, rid: str | None = None,
                 eos_id: int | None = None) -> list[int]:
        """Greedy-decode up to ``max_new_tokens`` tokens through the
        chain (stopping at ``eos_id`` if given, matching the engine's
        retirement rule). Returns the emitted token ids; raises typed
        ``FetchError``s (never hangs) when the swarm cannot serve the
        request."""
        rid = rid or f"req{self.stats['requests']}"
        self.stats["requests"] += 1
        req = _Request(rid, prompt, self.plan_chain(), self.k)
        logits = self._prefill_chain(req)
        req.out.append(_greedy(logits))
        while len(req.out) < max_new_tokens and \
                req.out[-1] != eos_id:
            logits = self._decode_chain(req)
            self.stats["decode_steps"] += 1
            req.out.append(_greedy(logits))
        self._release(req)
        return req.out

    def _pad_prompt(self, toks: list) -> torch.Tensor:
        """RIGHT-pad to the same power-of-two bucket the single-host
        engine uses, so the chain's prefill widths, and hence its
        logits, match the engine's bit for bit (``plen`` carries the
        true length for last-token gather / per-slot cache lengths)."""
        n = len(toks)
        padded = max(min(bucket_len(n), self.max_len), n) \
            if self.bucket_prompts else n
        row = torch.full((1, padded), self.pad_id, dtype=torch.int32)
        row[0, :n] = torch.tensor(toks, dtype=torch.int32)
        return row

    def _prefill_chain(self, req: _Request) -> torch.Tensor:
        """Initial prefill. On failure the router still holds the
        activations it was sending, so failover is resend-to-survivor:
        no replay needed."""
        x = self._pad_prompt(req.prompt)
        sid = 0
        while sid < self.k:
            addr = req.chain[sid]
            try:
                x = self._call(addr, {"op": "prefill_stage", "sid": sid,
                                      "rid": req.rid, "install": True,
                                      "plen": len(req.prompt)}, x)
            except (FetchError, OSError) as e:
                self._fail(req, sid, addr, e)
                continue
            req.lens[sid] = len(req.prompt)
            sid += 1
        return x

    def _decode_chain(self, req: _Request) -> torch.Tensor:
        x = torch.tensor([[req.out[-1]]], dtype=torch.int32)
        for sid in range(self.k):
            addr = req.chain[sid]
            try:
                x = self._call(addr, {"op": "decode_stage", "sid": sid,
                                      "rid": req.rid,
                                      "seq": req.lens[sid]}, x)
            except (FetchError, OSError) as e:
                self._fail(req, sid, addr, e)
                return self._recover_decode(req, sid)
            req.lens[sid] += 1
        return x

    def _recover_decode(self, req: _Request, fail_sid: int) -> torch.Tensor:
        """Bounded-replay re-prefill after a mid-decode failure at
        ``fail_sid`` (its replacement holder is already planned).
        Invariant on entry: stages < fail_sid committed the in-flight
        token (length L = len(prefix)); stages >= fail_sid are at
        L - 1. Stages 0..fail_sid are rebuilt (``_replay``), then the
        stages after it receive the in-flight position by one ordinary
        ``decode_stage``. Returns the logits the failed step was
        computing."""
        t0 = time.monotonic()
        self.stats["recoveries"] += 1
        self.stats["replayed_tokens"] += len(req.prefix())
        x = self._replay(req, fail_sid)
        while x is None:               # a holder failed during the replay
            x = self._replay(req, fail_sid)
        self.stats["recovery_s"] += time.monotonic() - t0
        for sid in range(fail_sid + 1, self.k):
            addr = req.chain[sid]
            try:
                x = self._call(addr, {"op": "decode_stage", "sid": sid,
                                      "rid": req.rid,
                                      "seq": req.lens[sid]}, x)
            except (FetchError, OSError) as e:
                # stages fail_sid+1 .. sid-1 committed the token during
                # this pass, so the invariant holds with the failure
                # point moved to sid: recurse
                self._fail(req, sid, addr, e)
                return self._recover_decode(req, sid)
            req.lens[sid] += 1
        return x

    def _replay(self, req: _Request, upto: int) -> torch.Tensor | None:
        """Rebuild stages 0..upto the way the uninterrupted run built
        them: the prompt's prefill (``install``), then one
        ``decode_stage`` per emitted token, through the chain. Their
        caches, and what stage ``upto`` returns for the in-flight token,
        are then bitwise the uninterrupted run's. The JAX package
        instead runs one prefill over the whole prefix, which computes
        the emitted positions by other arithmetic (an (S, D) product
        where decode made (1, D) rows, prefill attention where decode
        ran the flash-decode kernel); on the card those bits differ and
        can flip a greedy token. The wire protocol is the same. Returns
        None after a failure (its holder replaced: replay again)."""
        plen = len(req.prompt)
        x, sid = self._pad_prompt(req.prompt), 0
        try:
            for sid in range(upto + 1):
                x = self._call(req.chain[sid],
                               {"op": "prefill_stage", "sid": sid,
                                "rid": req.rid, "install": True,
                                "plen": plen}, x)
                req.lens[sid] = plen
            for tok in req.out:
                x = torch.tensor([[tok]], dtype=torch.int32)
                for sid in range(upto + 1):
                    x = self._call(req.chain[sid],
                                   {"op": "decode_stage", "sid": sid,
                                    "rid": req.rid,
                                    "seq": req.lens[sid]}, x)
                    req.lens[sid] += 1
        except (FetchError, OSError) as e:
            self._fail(req, sid, req.chain[sid], e)
            return None
        return x

    def _release(self, req: _Request) -> None:
        for addr in set(req.chain):
            if addr in self.dead:
                continue
            try:
                self._call_simple(addr, {"op": "release",
                                         "rid": req.rid})
            except (FetchError, OSError):
                pass

    def _call_simple(self, addr: Addr, header: dict) -> dict:
        if self.pool is not None:
            with self.pool.lease(addr) as conn:
                return conn.request_json(header)
        conn = PeerConn(addr, self.timeout)
        try:
            return conn.request_json(header)
        finally:
            conn.close()


def _greedy(logits: torch.Tensor) -> int:
    """argmax of a (1, V) logits row (the first of equal maxima, as
    the engine's and numpy's argmax)."""
    return int(logits[0].float().argmax())
