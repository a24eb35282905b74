"""Content-addressed chunk store for live checkpoint recovery (port of
``repro.checkpointing.store``; paper §2.4.2: joiners P2P-fetch state
from active peers).

Every pytree leaf is serialized to raw bytes and split into fixed-size
chunks addressed by the sha256 of their (uncompressed) contents:

    root/
      chunks/<aa>/<sha256-hex>        # zlib-deflated blob
      manifests/step_00000123.json    # tree structure -> chunk ids

Content addressing buys three things the flat npy-per-leaf layout
can't:

  * **dedup** — a chunk whose bytes didn't change between steps (or
    that appears twice inside one step: post-sync ``params`` and
    ``anchor`` are bit-identical trees) is stored and shipped once;
  * **verifiable transfer** — a chunk's id IS its checksum, so a swarm
    fetch validates every piece independently of which peer served it;
  * **resumable / striped fetch** — a joiner downloads disjoint chunk
    sets from several peers in parallel and re-requests only what's
    missing (see ``swarm.py``).

Chunk ids are computed on the uncompressed bytes; the on-disk blob is
zlib-deflated (quantized delta codes are low-entropy, so deflate
recovers most of the gap between the 8-bit code width and the code
entropy — see ``delta.py``).

All writes are atomic (tmp file + rename), so a crash mid-save never
corrupts the store and concurrent writers of the same chunk are
idempotent.

Host cost: deflate is the slow part (zlib-6 runs at tens of MB/s a
core), so a leaf's chunks are hashed and deflated on a thread pool
(``zlib`` and ``hashlib`` release the GIL) and read back the same way.
Which chunks are new is decided in manifest order before any is written,
so the manifest, the chunk ids, the blobs and the stats are those of a
serial put, byte for byte. Chunk ids are the reference's for the same
tensors. Leaves come back as CPU tensors.
"""
from __future__ import annotations

import collections
import concurrent.futures
import hashlib
import json
import os
import pathlib
import threading
import zlib
from typing import Any, Iterable

import numpy as np

from repro_torch.checkpointing import checkpoint as _ckpt

DEFAULT_CHUNK_BYTES = 1 << 20

_POOL: concurrent.futures.ThreadPoolExecutor | None = None
_POOL_LOCK = threading.Lock()


def pmap(fn, items: list) -> list:
    """``[fn(x) for x in items]`` on the store's thread pool (in order;
    inline for one item). ``fn`` must not itself wait on the pool."""
    global _POOL
    if len(items) <= 1:
        return [fn(x) for x in items]
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=os.cpu_count() or 4,
                thread_name_prefix="chunk-store")
    return list(_POOL.map(fn, items))


def _sha(data) -> str:
    return hashlib.sha256(data).hexdigest()


class ChunkCorruptError(IOError):
    """A blob's contents don't hash to its id (disk or peer
    corruption)."""


class ChunkMissingError(KeyError):
    """A chunk referenced by a manifest is not in the store."""


def chunk_ids(manifest: dict) -> list[str]:
    """Unique chunk ids referenced by ``manifest`` (first-appearance
    order, so consecutive ids usually belong to the same leaf)."""
    seen: dict[str, None] = {}
    for entry in manifest["keys"].values():
        for c in entry.get("chunks", ()):
            seen.setdefault(c["id"], None)
        delta = entry.get("delta")
        if delta:
            for c in delta["codes_chunks"]:
                seen.setdefault(c["id"], None)
            seen.setdefault(delta["codebook_id"], None)
    return list(seen)


class ChunkStore:
    """Chunked, deduplicating, content-addressed checkpoint store."""

    def __init__(self, root: str | pathlib.Path,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 compress_level: int = 6):
        self.root = pathlib.Path(root)
        self.chunk_bytes = int(chunk_bytes)
        self.compress_level = compress_level
        (self.root / "chunks").mkdir(parents=True, exist_ok=True)
        (self.root / "manifests").mkdir(parents=True, exist_ok=True)
        # bumped on every mutation through THIS instance; the gossip
        # digest caches its inventory sha against it (advisory only —
        # the sha itself is always recomputed when the version moved)
        self.version = 0
        self._lock = threading.Lock()
        self._digest_cache: tuple[int, tuple[int, str]] | None = None
        # refcounted pins: chunk ids / steps a ChunkPeer is actively
        # serving; gc() must not delete them out from under the wire
        self._pinned_chunks: collections.Counter = collections.Counter()
        self._pinned_steps: collections.Counter = collections.Counter()

    # -- blobs ---------------------------------------------------------------

    def _chunk_path(self, digest: str) -> pathlib.Path:
        return self.root / "chunks" / digest[:2] / digest

    def has(self, digest: str) -> bool:
        return self._chunk_path(digest).exists()

    def _write_blob(self, digest: str, blob: bytes) -> int:
        p = self._chunk_path(digest)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.parent / f".{digest}.{os.getpid()}.{threading.get_ident()}"
        tmp.write_bytes(blob)
        tmp.rename(p)  # atomic; concurrent same-digest writers agree
        with self._lock:
            self.version += 1
        return len(blob)

    def put(self, data: bytes) -> tuple[str, int]:
        """Store ``data``; returns (digest, bytes newly written — 0 on
        a dedup hit)."""
        digest = _sha(data)
        if self.has(digest):
            return digest, 0
        blob = zlib.compress(data, self.compress_level)
        return digest, self._write_blob(digest, blob)

    def put_blob(self, digest: str, blob: bytes) -> int:
        """Store an already-deflated blob as fetched from a peer,
        verifying it decompresses to bytes hashing to ``digest``."""
        if self.has(digest):
            return 0
        try:
            data = zlib.decompress(blob)
        except zlib.error as e:
            raise ChunkCorruptError(f"undecompressable blob for "
                                    f"{digest[:12]}: {e}") from e
        if hashlib.sha256(data).hexdigest() != digest:
            raise ChunkCorruptError(
                f"blob contents do not hash to {digest[:12]}")
        return self._write_blob(digest, blob)

    def get(self, digest: str) -> bytes:
        """Uncompressed chunk contents, integrity-checked."""
        try:
            data = zlib.decompress(self.get_blob(digest))
        except zlib.error as e:
            raise ChunkCorruptError(
                f"stored chunk {digest[:12]} is corrupt: {e}") from e
        if hashlib.sha256(data).hexdigest() != digest:
            raise ChunkCorruptError(
                f"stored chunk {digest[:12]} is corrupt")
        return data

    def get_blob(self, digest: str) -> bytes:
        """Raw deflated blob (what goes on the wire peer-to-peer)."""
        p = self._chunk_path(digest)
        if not p.exists():
            raise ChunkMissingError(digest)
        return p.read_bytes()

    def missing(self, manifest: dict) -> list[str]:
        return [d for d in chunk_ids(manifest) if not self.has(d)]

    # -- possession (gossip) -------------------------------------------------

    def inventory(self) -> list[str]:
        """Sorted ids of every chunk on disk — what this node can serve
        a streaming joiner (the gossip possession ground truth)."""
        out = []
        for sub in (self.root / "chunks").iterdir():
            out.extend(p.name for p in sub.iterdir()
                       if not p.name.startswith("."))
        return sorted(out)

    def inventory_digest(self) -> tuple[int, str]:
        """(n_chunks, sha256-hex over the sorted inventory): the compact
        possession summary a gossip round ships instead of the full id
        list. Cached against ``version`` so repeated polls between
        writes don't rescan the chunk tree."""
        with self._lock:
            cached = self._digest_cache
            version = self.version
        if cached is not None and cached[0] == version:
            return cached[1]
        ids = self.inventory()
        h = hashlib.sha256()
        for d in ids:
            h.update(d.encode())
        result = (len(ids), h.hexdigest())
        with self._lock:
            # only cache if no write raced the scan
            if self.version == version:
                self._digest_cache = (version, result)
        return result

    # -- pins ----------------------------------------------------------------

    def pin_chain(self, step: int) -> dict:
        """Pin the manifest chain ending at ``step`` (its steps and
        every referenced chunk) against gc while a peer streams it out.
        Returns an opaque token for :meth:`unpin`."""
        steps, ids = [], []
        s = step
        while True:
            m = self.load_manifest(s)
            steps.append(m["step"])
            ids.extend(chunk_ids(m))
            if m["kind"] != "delta":
                break
            s = m["prev_step"]
        with self._lock:
            self._pinned_steps.update(steps)
            self._pinned_chunks.update(ids)
        return {"steps": steps, "ids": ids}

    def pin_ids(self, ids) -> dict:
        """Pin loose chunk ids (no manifest required yet) against gc —
        a streaming joiner pins the chain it is assembling into a
        store that may concurrently run retention. Returns a token for
        :meth:`unpin`."""
        ids = list(ids)
        with self._lock:
            self._pinned_chunks.update(ids)
        return {"steps": [], "ids": ids}

    def unpin(self, token: dict) -> None:
        with self._lock:
            self._pinned_steps.subtract(token["steps"])
            self._pinned_chunks.subtract(token["ids"])
            self._pinned_steps += collections.Counter()  # drop <=0
            self._pinned_chunks += collections.Counter()

    # -- manifests -----------------------------------------------------------

    def _manifest_path(self, step: int) -> pathlib.Path:
        return self.root / "manifests" / f"step_{step:08d}.json"

    def write_manifest(self, manifest: dict) -> pathlib.Path:
        p = self._manifest_path(manifest["step"])
        tmp = p.with_name("." + p.name)
        tmp.write_text(json.dumps(manifest, indent=1, sort_keys=True))
        tmp.rename(p)
        with self._lock:
            self.version += 1
        return p

    def load_manifest(self, step: int) -> dict:
        return json.loads(self._manifest_path(step).read_text())

    # -- tombstones ----------------------------------------------------------
    # A retired step was removed ON PURPOSE (e.g. a policy version the
    # publisher force-expired). The tombstone lets the serving side
    # distinguish "deliberately gone" (typed StepRetiredError at the
    # fetcher) from "not written yet / wrong peer" (retryable), so a
    # lagging consumer fails fast instead of spinning on retries.

    def _retired_path(self) -> pathlib.Path:
        return self.root / "manifests" / "retired.json"

    def retired_steps(self) -> set[int]:
        p = self._retired_path()
        if not p.exists():
            return set()
        return set(json.loads(p.read_text()))

    def is_retired(self, step: int) -> bool:
        return int(step) in self.retired_steps()

    def retire_step(self, step: int) -> None:
        """Persist a tombstone for ``step`` (atomic, idempotent). Does
        not delete anything itself — run :meth:`gc` afterwards; the
        tombstone is what makes the deletion announceable."""
        steps = self.retired_steps()
        steps.add(int(step))
        p = self._retired_path()
        tmp = p.with_name("." + p.name)
        tmp.write_text(json.dumps(sorted(steps)))
        tmp.rename(p)
        with self._lock:
            self.version += 1

    def steps(self) -> list[int]:
        return sorted(int(p.stem.split("_")[1])
                      for p in (self.root / "manifests").iterdir()
                      if p.name.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    # -- pytrees -------------------------------------------------------------

    def _put_leaf(self, buf) -> tuple[list[dict], int, int]:
        """Chunk + store one leaf's bytes (any buffer); returns (chunk
        list, new_bytes, dedup_hits), as a serial put would: a chunk is
        written at its first appearance unless the store has it."""
        mv = memoryview(buf).cast("B")
        pieces = [mv[off:off + self.chunk_bytes]
                  for off in range(0, len(mv), self.chunk_bytes)]
        digests = pmap(_sha, pieces)
        seen: set[str] = set()
        todo = []
        for i, digest in enumerate(digests):
            if digest not in seen:
                seen.add(digest)
                if not self.has(digest):
                    todo.append(i)
        level = self.compress_level
        sizes = pmap(lambda i: self._write_blob(
            digests[i], zlib.compress(pieces[i], level)), todo)
        chunks = [{"id": d, "n": len(p)} for d, p in zip(digests, pieces)]
        return chunks, sum(sizes), len(pieces) - len(todo)

    def save_tree(self, step: int, tree: Any,
                  extra_meta: dict | None = None,
                  kind: str = "full") -> dict:
        """Full snapshot of ``tree`` at ``step``; returns the manifest
        (also persisted). ``manifest['stats']`` reports logical vs
        newly-stored bytes so dedup is observable."""
        flat = _ckpt._flatten(tree)
        keys: dict[str, dict] = {}
        logical = new_bytes = dedup = 0
        for key, leaf in flat.items():
            arr, dtype = _ckpt.host_array(leaf)
            chunks, nb, dd = self._put_leaf(arr.reshape(-1).view(np.uint8))
            keys[key] = {"shape": list(arr.shape), "dtype": dtype,
                         "chunks": chunks}
            logical += arr.nbytes
            new_bytes += nb
            dedup += dd
        manifest = {"format": "chunked-v1", "step": int(step),
                    "kind": kind, "meta": extra_meta or {},
                    "keys": keys,
                    "stats": {"logical_bytes": logical,
                              "new_bytes": new_bytes,
                              "dedup_chunks": dedup}}
        self.write_manifest(manifest)
        return manifest

    def read_bytes(self, ids: list[str]) -> bytearray:
        """The chunks' contents joined, each integrity-checked (fetched
        and inflated on the thread pool)."""
        return bytearray().join(pmap(self.get, list(ids)))

    def read_leaf(self, entry: dict):
        """The leaf as a CPU tensor of its stored dtype."""
        buf = self.read_bytes([c["id"] for c in entry["chunks"]])
        return _ckpt.leaf_from_bytes(buf, entry["dtype"], entry["shape"])

    def restore_tree(self, like: Any, step: int | None = None, *,
                     device="cuda") -> tuple[Any, dict]:
        """Restore a full/base snapshot into the structure of ``like``
        (CPU tensors). A delta manifest is a chain: it is replayed by
        ``delta.restore`` on ``device``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no manifests under {self.root}")
        manifest = self.load_manifest(step)
        if manifest["kind"] == "delta":
            from repro_torch.checkpointing import delta
            return delta.restore(self, like, step=step, device=device)
        out_flat = {k: self.read_leaf(manifest["keys"][k])
                    for k in _ckpt._flatten(like)}
        return _ckpt.unflatten_like(like, out_flat), manifest["meta"]

    # -- maintenance ---------------------------------------------------------

    def gc(self, keep_steps: Iterable[int] | None = None) -> dict:
        """Drop manifests not in ``keep_steps`` (None keeps all) and
        every chunk no kept manifest references. Keeping a delta step
        implicitly keeps its whole chain back to the base — a kept
        checkpoint must stay restorable. Steps and chunks pinned by a
        serving ``ChunkPeer`` survive regardless (``pinned`` in the
        returned stats counts what gc wanted to drop but couldn't), so
        retention can never truncate a checkpoint mid-stream."""
        keep = set(self.steps() if keep_steps is None else keep_steps)
        for s in list(keep):
            m = self.load_manifest(s)
            while m["kind"] == "delta":
                m = self.load_manifest(m["prev_step"])
                keep.add(m["step"])
        # pin checks happen per item at DELETION time (not one
        # snapshot up front): a ChunkPeer/StreamingFetcher pins a
        # whole chain atomically BEFORE serving/consuming a byte, so
        # re-reading the counters right before each unlink closes the
        # window where a pin taken mid-gc would be ignored
        def step_pinned(s: int) -> bool:
            with self._lock:
                return self._pinned_steps.get(s, 0) > 0

        def chunk_pinned(d: str) -> bool:
            with self._lock:
                return self._pinned_chunks.get(d, 0) > 0

        pinned_saves = 0
        removed_manifests = 0
        for s in self.steps():
            if s not in keep:
                if step_pinned(s):
                    pinned_saves += 1
                    continue
                self._manifest_path(s).unlink()
                removed_manifests += 1
        live: set[str] = set()
        for s in self.steps():
            live.update(chunk_ids(self.load_manifest(s)))
        removed_chunks = 0
        for sub in (self.root / "chunks").iterdir():
            for p in sub.iterdir():
                if p.name.startswith(".") or p.name in live:
                    continue
                if chunk_pinned(p.name):
                    continue
                p.unlink()
                removed_chunks += 1
        with self._lock:
            self.version += 1
        return {"manifests": removed_manifests, "chunks": removed_chunks,
                "pinned": pinned_saves}
