"""Chunk-availability gossip (port of ``repro.checkpointing.gossip``;
host code only; paper §2.4.2 overlap + SWARM: assume
peers are partial, unreliable replicas — never that every peer has
every chunk).

``ChunkGossip`` tracks which peer holds which chunks by polling each
peer's **possession digest** — ``{"op": "digest"}`` on the existing
``ChunkPeer`` protocol returns ``(latest, n_chunks, sha)`` where sha is
the sha256 over the sorted chunk-id inventory. Only when the sha moved
does gossip pull the full id list (``{"op": "inventory"}``), so a
steady-state poll costs one ~100-byte frame per peer per round instead
of re-shipping O(chunks) ids.

The resulting possession map feeds ``swarm_fetch(possession=...)`` so
ranges are only ever assigned to peers that actually hold them, and
``StreamingFetcher`` re-polls between retry rounds so peers that
join/recover mid-stream start serving immediately.

Failure model: a peer that misses ``expire_polls`` consecutive polls is
marked dead and its possession dropped (no stale routing to a corpse);
a transient stall keeps the last-known map until expiry — stale-but-
harmless, since every chunk is content-verified on arrival anyway.

The transport is pluggable (``transport(addr, request_dict) -> dict``):
the default opens a short-lived framed TCP connection per poll; the
property tests drive the same state machine over in-memory stores.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable

from repro_torch.checkpointing.p2p import (FetchError, PeerConn, PeerConnPool,
                                     RetryPolicy, retry_call)

Addr = tuple  # (host, port)


def socket_transport(timeout: float = 5.0, *,
                     pool: PeerConnPool | None = None,
                     policy: RetryPolicy | None = None
                     ) -> Callable[[Addr, dict], dict]:
    """One framed TCP round-trip per request.

    Without a ``pool``: a fresh connection per poll (a crashed peer
    costs one refused connect, not a wedged socket). With one: the
    connection is leased from the capped per-peer pool and reused
    across rounds; a conn that errored is discarded, so a stale pooled
    socket costs one retry, never a wedged round. ``policy`` wraps the
    round-trip in the shared retry/backoff schedule (each retry leases
    a fresh conn — gossip ops are read-only, hence idempotent)."""

    def once(addr: Addr, payload: dict) -> dict:
        if pool is not None:
            with pool.lease(addr) as conn:
                return conn.request_json(payload)
        conn = PeerConn(addr, timeout)
        try:
            return conn.request_json(payload)
        finally:
            conn.close()

    def send(addr: Addr, payload: dict) -> dict:
        if policy is None:
            return once(addr, payload)
        return retry_call(lambda: once(addr, payload), policy=policy)

    return send


@dataclasses.dataclass
class PeerView:
    """What gossip currently believes about one peer."""
    addr: Addr
    chunks: frozenset = frozenset()
    latest: int | None = None
    sha: str | None = None
    misses: int = 0          # consecutive failed polls
    alive: bool = False      # answered at least once, not expired
    polls: int = 0


class ChunkGossip:
    """Per-peer chunk-possession tracking via periodic digest polls."""

    def __init__(self, peers: Iterable[Addr], *,
                 transport: Callable[[Addr, dict], dict] | None = None,
                 timeout: float = 5.0, expire_polls: int = 3,
                 pool: "PeerConnPool | None" = None,
                 policy: RetryPolicy | None = None):
        self.transport = transport or socket_transport(
            timeout, pool=pool, policy=policy)
        self.expire_polls = int(expire_polls)
        self._views: dict[Addr, PeerView] = {}
        self._lock = threading.Lock()
        self._poller: threading.Thread | None = None
        self._stop = threading.Event()
        self.stats = {"polls": 0, "digests": 0, "inventories": 0,
                      "expired": 0}
        for addr in peers:
            self.add_peer(addr)

    # -- membership ----------------------------------------------------------

    def add_peer(self, addr: Addr) -> None:
        with self._lock:
            self._views.setdefault(tuple(addr), PeerView(tuple(addr)))

    def remove_peer(self, addr: Addr) -> None:
        """Drop a peer immediately (graceful leave / deathrattle — no
        need to wait out the expiry window)."""
        with self._lock:
            self._views.pop(tuple(addr), None)

    def peers(self) -> list[Addr]:
        with self._lock:
            return list(self._views)

    # -- polling -------------------------------------------------------------

    def _poll_peer(self, view: PeerView) -> None:
        try:
            digest = self.transport(view.addr, {"op": "digest"})
            self.stats["digests"] += 1
            new_sha = digest.get("sha")
            if new_sha != view.sha:
                inv = self.transport(view.addr, {"op": "inventory"})
                self.stats["inventories"] += 1
                chunks = frozenset(inv["ids"])
            else:
                chunks = view.chunks
            with self._lock:
                # peer may have been removed while we were polling
                live = self._views.get(view.addr)
                if live is not None:
                    live.chunks = chunks
                    live.latest = digest.get("latest")
                    live.sha = new_sha
                    live.misses = 0
                    live.alive = True
                    live.polls += 1
        except (FetchError, OSError, ValueError, KeyError):
            with self._lock:
                live = self._views.get(view.addr)
                if live is not None:
                    live.misses += 1
                    live.polls += 1
                    if live.alive and live.misses >= self.expire_polls:
                        live.alive = False
                        live.chunks = frozenset()
                        live.latest = None
                        live.sha = None
                        self.stats["expired"] += 1

    def poll_once(self) -> dict:
        """One synchronous gossip round over every tracked peer.
        Returns the updated possession map."""
        self.stats["polls"] += 1
        with self._lock:
            views = list(self._views.values())
        for v in views:
            self._poll_peer(v)
        return self.possession

    # -- views ---------------------------------------------------------------

    @property
    def possession(self) -> dict:
        """addr -> frozenset(chunk ids) for every live peer (what
        ``swarm_fetch(possession=...)`` consumes)."""
        with self._lock:
            return {a: v.chunks for a, v in self._views.items()
                    if v.alive}

    def latest_step(self) -> int | None:
        with self._lock:
            steps = [v.latest for v in self._views.values()
                     if v.alive and v.latest is not None]
        return max(steps) if steps else None

    def holders(self, chunk_id: str) -> list[Addr]:
        with self._lock:
            return [a for a, v in self._views.items()
                    if v.alive and chunk_id in v.chunks]

    def live_peers(self) -> list[Addr]:
        with self._lock:
            return [a for a, v in self._views.items() if v.alive]

    # -- background poller ---------------------------------------------------

    def start(self, interval: float = 1.0) -> None:
        """Poll every ``interval`` seconds on a daemon thread."""
        if self._poller is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                self.poll_once()

        self._poller = threading.Thread(target=loop, daemon=True)
        self._poller.start()

    def stop(self) -> None:
        if self._poller is None:
            return
        self._stop.set()
        self._poller.join(timeout=2)
        self._poller = None


def store_transport(stores: dict) -> Callable[[Addr, dict], dict]:
    """In-memory transport over ``{addr: ChunkStore|None}`` — the
    deterministic harness / property tests drive the gossip state
    machine without sockets. ``None`` (or a missing addr) models a
    dead peer; a callable value is invoked first and may raise to model
    a stall."""

    def send(addr: Addr, payload: dict) -> dict:
        entry = stores.get(tuple(addr))
        if callable(entry):
            entry = entry()
        if entry is None:
            raise ConnectionError(f"peer {addr} unreachable")
        op = payload.get("op")
        if op == "digest":
            n, sha = entry.inventory_digest()
            return {"latest": entry.latest_step(), "n_chunks": n,
                    "sha": sha, "version": entry.version}
        if op == "inventory":
            return {"ids": entry.inventory()}
        if op == "have":
            return {"have": [int(entry.has(d))
                             for d in payload["ids"]]}
        raise ValueError(f"unknown op {op!r}")

    return send
