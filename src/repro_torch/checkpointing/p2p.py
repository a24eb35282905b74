"""Peer-to-peer checkpoint transmission (port of
``repro.checkpointing.p2p``, paper §2.4.2). Host code only: the wire
format is byte-compatible with the reference's, so a peer of either
package serves a fetcher of the other.

A joining node downloads the checkpoint directly from any active peer
instead of central storage. Real TCP implementation (tested on
localhost): an active peer runs ``CheckpointServer`` next to training;
``fetch_checkpoint`` streams the manifest + arrays with length-prefixed
frames and sha256 integrity checks.

Failure semantics: every failure mode surfaces as a typed
``FetchError`` subclass (peer closed mid-frame, frame checksum
mismatch, peer has no checkpoint, checkpoint swapped out mid-serve) so
a caller can catch-and-retry without string matching. The server reads
the whole checkpoint into memory BEFORE the first byte goes on the
wire, so a concurrent ``save`` swapping the ``step_*`` directory can
never truncate a stream mid-transfer — at worst the snapshot read
fails and is retried against the new latest step.

Both of the paper's onboarding modes are realized by the trainer:
  * blocking     — the trainer pauses at the outer boundary until the
                   fetch completes (the mode INTELLECT-1 actually used);
  * non-blocking — fetch on a thread while training continues; the
                   joiner enters at the NEXT outer step with zero
                   pseudo-gradient (weight 0 in the elastic ring).

For the chunked content-addressed store and the multi-peer striped
fetch, see ``swarm.py``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import io
import json
import pathlib
import random
import socket
import struct
import threading
import time


class FetchError(Exception):
    """Base of all typed P2P checkpoint-transfer failures."""


class PeerClosedError(FetchError, ConnectionError):
    """Peer hung up mid-frame (crash or abrupt shutdown)."""


class ChecksumError(FetchError, IOError):
    """A frame's sha256 didn't match its payload (corruption in
    transit)."""


class EmptyPeerError(FetchError, FileNotFoundError):
    """The peer is healthy but has no checkpoint yet."""


class RetryableFetchError(FetchError, IOError):
    """The peer's checkpoint vanished mid-serve (concurrent save swap);
    the fetch is safe to retry immediately."""


class PeerTimeoutError(FetchError, TimeoutError):
    """A framed-TCP op exceeded its deadline (stalled peer or link).
    Raised instead of the raw ``socket.timeout`` so callers can treat a
    stall exactly like a crash — typed, catch-and-failover."""


class RetryDeadlineError(FetchError, TimeoutError):
    """A retry loop ran out of TOTAL wall-clock budget
    (``RetryPolicy.max_elapsed_s`` / ``StreamingFetcher``
    ``max_elapsed_s``): under churn, per-attempt backoff can stack
    unboundedly — the deadline caps the whole ladder. Chains the last
    underlying failure as ``__cause__``."""


# -- retry / backoff ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Shared retry/backoff schedule for framed-TCP ops.

    ``attempts`` total tries; between failures sleep
    ``min(max_delay, base_delay * 2**attempt)`` scaled by a uniform
    jitter in ``[1, 1 + jitter)`` so a fleet of retriers doesn't
    thundering-herd a recovering peer. ``retry_on`` lists the exception
    families worth retrying; ``no_retry`` carves out subclasses that
    are definitive answers, not transport noise (``EmptyPeerError`` is
    a FileNotFoundError and therefore an OSError — without the carve-
    out it would be retried pointlessly)."""

    attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5
    retry_on: tuple = (PeerClosedError, ChecksumError,
                       RetryableFetchError, PeerTimeoutError, OSError)
    no_retry: tuple = (EmptyPeerError,)
    # total wall-clock budget across ALL attempts (None = unbounded):
    # once the elapsed time plus the next backoff would cross it, the
    # loop raises RetryDeadlineError instead of sleeping
    max_elapsed_s: float | None = None


def retry_call(fn, *, policy: RetryPolicy | None = None,
               describe: str = "", sleep=time.sleep, rng=None,
               clock=time.monotonic):
    """Run ``fn()`` under ``policy``; re-raises the last error once the
    attempts are exhausted. ``sleep``/``rng``/``clock`` are injectable
    for deterministic tests (``rng.random()`` in [0, 1) drives jitter).
    With ``policy.max_elapsed_s`` set, the TOTAL wall-clock across
    attempts (including the about-to-happen backoff sleep) is capped:
    crossing it raises :class:`RetryDeadlineError` from the last
    underlying failure."""
    policy = policy or RetryPolicy()
    roll = rng.random if rng is not None else random.random
    t0 = clock()
    last: BaseException | None = None
    for attempt in range(max(1, policy.attempts)):
        try:
            return fn()
        except policy.no_retry:
            raise
        except policy.retry_on as e:
            last = e
            if attempt + 1 >= max(1, policy.attempts):
                raise
            delay = min(policy.max_delay,
                        policy.base_delay * (2 ** attempt))
            delay *= 1.0 + policy.jitter * roll()
            if policy.max_elapsed_s is not None and \
                    (clock() - t0) + delay > policy.max_elapsed_s:
                raise RetryDeadlineError(
                    f"retry budget {policy.max_elapsed_s}s exhausted "
                    f"after {attempt + 1} attempts"
                    + (f" ({describe})" if describe else "")) from e
            sleep(delay)
    raise last  # pragma: no cover — loop always returns or raises


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    digest = hashlib.sha256(payload).digest()
    sock.sendall(struct.pack("!Q", len(payload)) + digest + payload)


class PeerConn:
    """One framed TCP connection to a peer speaking the JSON-op
    protocol (``ChunkPeer``, the gossip layer and the swarm-serve stage
    RPCs ride on it): send a JSON request frame, read response frames.
    Shared by ``swarm_fetch``, ``ChunkGossip``, ``StreamingFetcher``
    and ``StageServer`` clients so every transport-level failure
    surfaces as the same typed ``FetchError`` family — a deadline blown
    anywhere becomes ``PeerTimeoutError``, never a raw socket.timeout."""

    def __init__(self, addr: tuple, timeout: float):
        self.addr = tuple(addr)
        with self._timeouts_typed():
            self.sock = socket.create_connection(addr, timeout=timeout)
        self.sock.settimeout(timeout)
        # a request is often two frames (a stage RPC's header and
        # tensor): without this, Nagle holds the second until the first
        # is acknowledged, a delayed ACK of up to 40 ms on loopback
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    @contextlib.contextmanager
    def _timeouts_typed(self):
        try:
            yield
        except socket.timeout as e:
            raise PeerTimeoutError(
                f"peer {getattr(self, 'addr', '?')} timed out") from e

    def send(self, payload: dict) -> None:
        with self._timeouts_typed():
            _send_frame(self.sock, json.dumps(payload).encode())

    def send_bytes(self, blob: bytes) -> None:
        with self._timeouts_typed():
            _send_frame(self.sock, blob)

    def request(self, payload: dict) -> bytes:
        self.send(payload)
        return self.recv_frame()

    def request_json(self, payload: dict) -> dict:
        return json.loads(self.request(payload))

    def recv_frame(self) -> bytes:
        with self._timeouts_typed():
            return _recv_frame(self.sock)

    def recv_json(self) -> dict:
        return json.loads(self.recv_frame())

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class PeerConnPool:
    """Capped per-peer pool of reusable ``PeerConn``s.

    ``swarm_fetch`` rounds, gossip polls and stage RPCs used to open
    one fresh connection per peer per round — too chatty for 100-peer
    swarms. The pool keeps up to ``max_idle_per_peer`` healthy
    connections per address; ``lease`` hands one out (creating on
    miss) and returns it on clean exit, discarding it if the op
    raised (a conn that saw a transport error is never reused).
    Thread-safe; a connection is owned exclusively while leased."""

    def __init__(self, timeout: float = 20.0,
                 max_idle_per_peer: int = 2):
        self.timeout = timeout
        self.max_idle_per_peer = int(max_idle_per_peer)
        self._idle: dict[tuple, collections.deque] = {}
        self._lock = threading.Lock()
        self._closed = False
        self.stats = {"created": 0, "reused": 0, "discarded": 0}

    def acquire(self, addr: tuple) -> PeerConn:
        addr = tuple(addr)
        with self._lock:
            q = self._idle.get(addr)
            if q:
                self.stats["reused"] += 1
                return q.popleft()
        conn = PeerConn(addr, self.timeout)
        with self._lock:
            self.stats["created"] += 1
        return conn

    def release(self, conn: PeerConn, *, healthy: bool = True) -> None:
        with self._lock:
            q = self._idle.setdefault(conn.addr, collections.deque())
            if healthy and not self._closed and \
                    len(q) < self.max_idle_per_peer:
                q.append(conn)
                return
            self.stats["discarded"] += 1
        conn.close()

    @contextlib.contextmanager
    def lease(self, addr: tuple):
        conn = self.acquire(addr)
        try:
            yield conn
        except BaseException:
            self.release(conn, healthy=False)
            raise
        else:
            self.release(conn)

    def idle_count(self, addr: tuple | None = None) -> int:
        with self._lock:
            if addr is not None:
                return len(self._idle.get(tuple(addr), ()))
            return sum(len(q) for q in self._idle.values())

    def discard_peer(self, addr: tuple) -> None:
        """Drop every idle conn to a peer known dead."""
        with self._lock:
            q = self._idle.pop(tuple(addr), None)
        for conn in (q or ()):
            conn.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            qs = list(self._idle.values())
            self._idle.clear()
        for q in qs:
            for conn in q:
                conn.close()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = io.BytesIO()
    while buf.tell() < n:
        chunk = sock.recv(min(1 << 20, n - buf.tell()))
        if not chunk:
            raise PeerClosedError("peer closed mid-frame")
        buf.write(chunk)
    return buf.getvalue()


def _recv_frame(sock: socket.socket) -> bytes:
    header = _recv_exact(sock, 8 + 32)
    (length,) = struct.unpack("!Q", header[:8])
    digest = header[8:40]
    payload = _recv_exact(sock, length)
    if hashlib.sha256(payload).digest() != digest:
        raise ChecksumError("checksum mismatch in checkpoint frame")
    return payload


class CheckpointServer:
    """Serves the latest checkpoint directory to joining peers."""

    # bounded retries when a concurrent save swaps step_* mid-read
    SNAPSHOT_ATTEMPTS = 3

    def __init__(self, ckpt_dir: str | pathlib.Path,
                 host: str = "127.0.0.1", port: int = 0):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._handle(conn)
            except OSError:
                pass
            finally:
                conn.close()

    def _read_step_dir(self, d: pathlib.Path) -> list[bytes]:
        """One consistent snapshot of ``d``: manifest first, then the
        arrays in manifest-key order. Raises FileNotFoundError if a
        concurrent save swapped the directory away mid-read, and
        re-reads the manifest afterwards so a same-step REPLACEMENT
        mid-read (old manifest + new arrays, all checksums valid)
        can't be served as a checkpoint state that never existed —
        ``save`` stamps every manifest with a fresh nonce, so two
        saves of the same step are never byte-identical."""
        manifest = (d / "manifest.json").read_bytes()
        info = json.loads(manifest)
        frames = [manifest]
        for key in sorted(info["keys"]):
            frames.append(
                (d / "arrays" / info["keys"][key]["file"]).read_bytes())
        if (d / "manifest.json").read_bytes() != manifest:
            raise FileNotFoundError("step dir replaced mid-read")
        return frames

    def _snapshot_latest(self) -> list[bytes] | dict:
        """Read the whole latest checkpoint into memory before serving
        a single byte. The step dir path is resolved ONCE per attempt;
        a vanished/replaced file (save swap race) retries against the
        new latest instead of streaming a torn checkpoint."""
        import time

        from repro_torch.checkpointing import checkpoint as ckpt
        saw_step = False
        for attempt in range(self.SNAPSHOT_ATTEMPTS):
            step = ckpt.latest_step(self.ckpt_dir)
            if step is None:
                # either truly empty, or we landed inside save()'s
                # rename swap of the only step — re-look before
                # declaring the peer empty
                time.sleep(0.01 * (attempt + 1))
                continue
            saw_step = True
            d = self.ckpt_dir / f"step_{step:08d}"
            try:
                return self._read_step_dir(d)
            except (FileNotFoundError, NotADirectoryError,
                    json.JSONDecodeError):
                continue
        # a peer that had a step at ANY point is retryable, not empty
        return {"error": "retry" if saw_step else "empty"}

    def _handle(self, conn: socket.socket) -> None:
        snap = self._snapshot_latest()
        if isinstance(snap, dict):
            _send_frame(conn, json.dumps(snap).encode())
            return
        for frame in snap:
            _send_frame(conn, frame)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self._sock.close()


def fetch_checkpoint(peer: tuple[str, int],
                     dest_dir: str | pathlib.Path,
                     timeout: float = 60.0) -> pathlib.Path:
    """Download the peer's latest checkpoint into ``dest_dir``; returns
    the local checkpoint path (same on-disk format as checkpoint.save).

    Raises ``EmptyPeerError`` / ``RetryableFetchError`` /
    ``PeerClosedError`` / ``ChecksumError`` (all ``FetchError``) so the
    caller can retry or fail over to another peer."""
    dest_dir = pathlib.Path(dest_dir)
    with socket.create_connection(peer, timeout=timeout) as sock:
        manifest_raw = _recv_frame(sock)
        manifest = json.loads(manifest_raw)
        if manifest.get("error") == "empty":
            raise EmptyPeerError("peer has no checkpoint yet")
        if manifest.get("error") == "retry":
            raise RetryableFetchError(
                "peer checkpoint swapped mid-serve; retry")
        step = manifest["step"]
        tmp = dest_dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            import shutil
            shutil.rmtree(tmp)
        (tmp / "arrays").mkdir(parents=True)
        (tmp / "manifest.json").write_bytes(manifest_raw)
        for key in sorted(manifest["keys"]):
            payload = _recv_frame(sock)
            (tmp / "arrays" / manifest["keys"][key]["file"]).write_bytes(
                payload)
    final = dest_dir / f"step_{step:08d}"
    if final.exists():
        import shutil
        shutil.rmtree(final)
    tmp.rename(final)
    return final
