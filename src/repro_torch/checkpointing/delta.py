"""Quantized delta checkpoints over the chunk store (port of
``repro.checkpointing.delta``).

The paper's 400x idea — ship int8-coded differences instead of fp32
state — applied to recovery traffic: after a full **base** snapshot,
each checkpoint persists only the int8/int4-coded difference against a
**reference** chain, through the sync engine's codec (the scale-aware
6-sigma / bucket-mean scheme the ring uses on pseudo-gradients).

Exactness contract: the writer deltas against its own *reconstruction*
``ref`` and advances ``ref`` by the dequantized delta it just stored:

    ref_0   = base                      (stored exactly)
    q_t     = quantize(theta_t - ref_{t-1})
    ref_t   = ref_{t-1} + codebook_t[codes_t]     # one fp32 add

A restorer replaying the chain computes the same ``ref_t`` bit for bit,
and every manifest records the sha256 of the reconstruction it must
produce. The apply is one fp32 add of a looked-up value, with no
multiply to contract, so the CUDA kernel, the plain PyTorch version and
the reference's numpy add give the same bits: a chain written on either
device, or by either package, replays on any of them.

Device route: the writer's reference (one flat fp32 tensor per float
leaf) and the replayer's live on their ``device``. On CUDA the int8
encode is ``ops.quantize_pseudograd(theta, ref)`` on a ``(1, numel)``
row (kernel ``pseudograd_encode_hist``) and every apply, int8 or int4,
is ``ops.dequantize_add`` (kernel ``decode_add``; an int4 codebook is
padded to 256 entries); on the CPU both are the plain versions. Only
the codes, the codebooks and the reference's bytes (to hash them) go to
the host. int4 codes come from the plain ``compression.quantize4``, as
in the reference, and are unpacked hi-nibble first. On CUDA the writer
and the replayer work on a stream of their own and synchronize it
before they return.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.checkpointing import checkpoint as _ckpt
from repro_torch.checkpointing.store import (ChunkMissingError, ChunkStore,
                                             chunk_ids, pmap)
from repro_torch.core import compression
from repro_torch.kernels import ops

_BOOK = 256                   # the decode kernel's codebook width


class DeltaChainError(ValueError):
    """The stored chain does not reproduce the manifest's recorded
    reconstruction (corruption or writer/reader codec drift)."""


@dataclasses.dataclass(frozen=True)
class DeltaConfig:
    base_every: int = 8        # full re-anchor every N checkpoints
    codec: str = "int8"        # 'int8' | 'int4'


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point and t.numel() > 0


def _apply_delta(ref: torch.Tensor, codes: torch.Tensor,
                 codebook: torch.Tensor) -> None:
    """``ref += codebook[codes]`` in fp32, in place: the ONE apply path
    shared by writer and restorer (``decode_add``)."""
    book = codebook.reshape(1, -1)
    if book.shape[1] < _BOOK:
        book = torch.nn.functional.pad(book, (0, _BOOK - book.shape[1]))
    ops.dequantize_add(ops.Quantized(codes.reshape(1, -1), book),
                       ref.view(1, -1))


def _unpack4(packed: torch.Tensor, numel: int) -> torch.Tensor:
    """Hi-nibble-first unpack matching ``compression.quantize4``'s
    packing (the reference's ``_unpack4``)."""
    return torch.stack([packed // 16, packed % 16],
                       dim=-1).reshape(-1)[:numel]


def _encode(new: torch.Tensor, ref: torch.Tensor, cfg: DeltaConfig
            ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Quantize ``new - ref`` (flat fp32 on one device); returns (codes
    for ``_apply_delta``, fp32 codebook, the codes' wire bytes as a
    host uint8 array)."""
    if cfg.codec == "int8":
        q = ops.quantize_pseudograd(new[None], ref[None])
        codes = q.codes[0]
        return codes, q.codebook[0], codes.cpu().numpy()
    if cfg.codec == "int4":
        q4 = compression.quantize4((new - ref)[None])
        packed = q4.packed[0]
        return (_unpack4(packed, new.numel()), q4.codebook[0],
                packed.cpu().numpy())
    raise ValueError(f"unknown delta codec {cfg.codec!r}")


def _decode_codes(buf, codec: str, numel: int,
                  device: torch.device) -> torch.Tensor:
    raw = torch.frombuffer(buf, dtype=torch.uint8).to(device)
    if codec == "int8":
        return raw
    return _unpack4(raw, numel)


def _sha_all(refs: list[torch.Tensor]) -> list[str]:
    """sha256 of each flat fp32 tensor's bytes (copied to the host in
    order, hashed on the store's thread pool)."""
    host = [r.detach().cpu().numpy() for r in refs]
    return pmap(lambda a: hashlib.sha256(a).hexdigest(), host)


class _OnDevice:
    """A device and, on CUDA, a stream of its own for the work."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream = None

    def _on_stream(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        # inputs made on the caller's stream are ready before we read them
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._stream)

    def _synchronize(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()


class DeltaCheckpointer(_OnDevice):
    """Writer for a base + quantized-delta checkpoint chain; its
    reference lives on ``device``."""

    def __init__(self, store: ChunkStore, cfg: DeltaConfig = DeltaConfig(),
                 device="cuda"):
        super().__init__(device)
        self.store = store
        self.cfg = cfg
        self._ref: dict[str, torch.Tensor] | None = None   # flat fp32
        self._sig: dict[str, tuple] | None = None
        self._since_base = 0
        self._prev_step: int | None = None
        self._base_step: int | None = None

    def save(self, step: int, tree: Any,
             extra_meta: dict | None = None) -> dict:
        flat = {k: _ckpt.as_tensor(v).detach()
                for k, v in _ckpt._flatten(tree).items()}
        sig = {k: (tuple(t.shape), _ckpt.dtype_name(t.dtype))
               for k, t in flat.items()}
        float_keys = [k for k, t in flat.items() if _is_float(t)]
        rebase = (self._ref is None or sig != self._sig
                  or not float_keys
                  or self.cfg.base_every <= 1
                  or self._since_base >= self.cfg.base_every)
        try:
            with self._on_stream():
                if rebase:
                    manifest = self.store.save_tree(step, tree, extra_meta,
                                                    kind="base")
                    self._ref = None
                    self._ref = {k: flat[k].to(self.device, torch.float32,
                                               copy=True).reshape(-1)
                                 for k in float_keys}
                    self._sig = sig
                    self._since_base = 1
                    self._base_step = step
                else:
                    manifest = self._save_delta(step, flat, float_keys,
                                                extra_meta)
                    self._since_base += 1
                self._synchronize()
        except BaseException:
            # a partial write must not leave the reference ahead of the
            # persisted chain (the delta applies it in place): re-anchor
            self._ref = None
            raise
        self._prev_step = step
        return manifest

    def _save_delta(self, step: int, flat: dict[str, torch.Tensor],
                    float_keys: list[str],
                    extra_meta: dict | None) -> dict:
        keys: dict[str, dict] = {}
        logical = new_bytes = codes_bytes = dedup = 0
        for key, t in flat.items():
            logical += t.numel() * t.element_size()
            if key not in float_keys:
                # non-float leaves (step counters...) ship full: tiny
                arr, dtype = _ckpt.host_array(t)
                chunks, nb, dd = self.store._put_leaf(
                    arr.reshape(-1).view(np.uint8))
                keys[key] = {"shape": list(arr.shape), "dtype": dtype,
                             "chunks": chunks}
                new_bytes += nb
                dedup += dd
                continue
            new = t.to(self.device, torch.float32).reshape(-1)
            codes, codebook, wire = _encode(new, self._ref[key], self.cfg)
            del new
            chunks, nb, dd = self.store._put_leaf(wire)
            book_id, book_nb = self.store.put(
                codebook.cpu().numpy().tobytes())
            _apply_delta(self._ref[key], codes, codebook)
            keys[key] = {"shape": list(t.shape),
                         "dtype": _ckpt.dtype_name(t.dtype),
                         "delta": {"codec": self.cfg.codec,
                                   "numel": int(t.numel()),
                                   "codes_chunks": chunks,
                                   "codebook_id": book_id}}
            new_bytes += nb + book_nb
            codes_bytes += wire.nbytes
            dedup += dd
        ref_sha = dict(zip(float_keys,
                           _sha_all([self._ref[k] for k in float_keys])))
        manifest = {"format": "chunked-v1", "step": int(step),
                    "kind": "delta", "meta": extra_meta or {},
                    "base_step": self._base_step,
                    "prev_step": self._prev_step,
                    "ref_sha": ref_sha, "keys": keys,
                    "stats": {"logical_bytes": logical,
                              "new_bytes": new_bytes,
                              "codes_bytes": codes_bytes,
                              "dedup_chunks": dedup}}
        self.store.write_manifest(manifest)
        return manifest

    def reference(self, like: Any) -> Any:
        """The writer-side reconstruction shaped like ``like``, as CPU
        copies (what a chain restore must reproduce bit-exactly)."""
        assert self._ref is not None, "no checkpoint written yet"
        out = {}
        for k, a in _ckpt._flatten(like).items():
            a = _ckpt.as_tensor(a)
            out[k] = (self._ref[k].reshape(a.shape).to(
                "cpu", a.dtype, copy=True) if k in self._ref else a)
        return _ckpt.unflatten_like(like, out)


class ChainReplayer(_OnDevice):
    """Incremental, streaming-safe delta-chain replay on ``device``.

    Built from the manifest chain (base first), it tracks which chunk
    ids each step still lacks; ``on_chunk`` (called from the fetch
    worker threads as verified chunks land in the store) replays every
    consecutive chain step the moment its last chunk arrives, so by the
    time the final chunk lands the reconstruction is assembled and a
    joiner's restore is one ``finish`` call.

    Replay is the SAME apply path as the writer's (``_apply_delta``),
    sha-verified per step against the writer's recorded reconstruction.
    Thread-safe: fetch workers race on ``on_chunk``; replay itself runs
    under the lock, strictly in chain order.
    """

    def __init__(self, store: ChunkStore, chain: list[dict],
                 device="cuda"):
        assert chain, "empty manifest chain"
        assert chain[0]["kind"] != "delta", \
            "chain must start at a base/full manifest"
        super().__init__(device)
        self.store = store
        self.chain = chain
        self._lock = threading.Lock()
        self._applied = 0
        self._ref: dict[str, torch.Tensor] = {}
        # per-step sets of chunk ids not yet locally present
        self._pending: list[set[str]] = [
            {d for d in chunk_ids(m) if not store.has(d)}
            for m in chain]
        self.stats = {"replayed_steps": 0, "replayed_on_stream": 0}

    # -- progress ------------------------------------------------------------

    @property
    def applied_steps(self) -> int:
        with self._lock:
            return self._applied

    @property
    def complete(self) -> bool:
        with self._lock:
            return self._applied == len(self.chain)

    def remaining_chunks(self) -> int:
        with self._lock:
            return len(set().union(*self._pending)) if self._pending \
                else 0

    def on_chunk(self, digest: str, n_bytes: int = 0) -> int:
        """A verified chunk landed in the store; replay whatever chain
        steps just became complete. Returns steps newly applied."""
        del n_bytes
        with self._lock:
            for pend in self._pending:
                pend.discard(digest)
            applied = self._advance_locked()
            self.stats["replayed_on_stream"] += applied
            return applied

    def advance(self) -> int:
        """Replay every consecutive step whose chunks are all local
        (recomputed from the store: the non-streaming entry point)."""
        with self._lock:
            for i, m in enumerate(self.chain[self._applied:],
                                  self._applied):
                self._pending[i] = {d for d in chunk_ids(m)
                                    if not self.store.has(d)}
            return self._advance_locked()

    # -- replay --------------------------------------------------------------

    def _advance_locked(self) -> int:
        applied = 0
        while self._applied < len(self.chain) and \
                not self._pending[self._applied]:
            with self._on_stream():
                self._apply_step(self.chain[self._applied])
                self._synchronize()
            self._applied += 1
            applied += 1
            self.stats["replayed_steps"] += 1
        return applied

    def _apply_step(self, m: dict) -> None:
        if m["kind"] != "delta":       # the base: load float leaves
            for key, entry in m["keys"].items():
                t = self.store.read_leaf(entry)
                if _is_float(t):
                    self._ref[key] = t.to(self.device, torch.float32,
                                          copy=True).reshape(-1)
            return
        keys = []
        for key, entry in m["keys"].items():
            delta = entry.get("delta")
            if delta is None:
                continue
            wire = self.store.read_bytes(
                [c["id"] for c in delta["codes_chunks"]])
            codes = _decode_codes(wire, delta["codec"], delta["numel"],
                                  self.device)
            codebook = torch.frombuffer(
                bytearray(self.store.get(delta["codebook_id"])),
                dtype=torch.float32).to(self.device)
            _apply_delta(self._ref[key], codes, codebook)
            keys.append(key)
        for key, got in zip(keys, _sha_all([self._ref[k] for k in keys])):
            if got != m["ref_sha"][key]:
                raise DeltaChainError(
                    f"chain replay diverged at step {m['step']} "
                    f"leaf {key!r}")

    def finish(self, like: Any) -> tuple[Any, dict]:
        """The fully replayed tree shaped/dtyped like ``like``, on the
        replay device, plus the target step's meta. A leaf whose dtype
        is fp32 is the replayer's own buffer, handed over. Raises
        ``ChunkMissingError`` if the chain has not fully streamed in."""
        with self._lock:
            if self._applied != len(self.chain):
                missing = set().union(
                    *self._pending[self._applied:])
                raise ChunkMissingError(
                    f"chain incomplete: {len(self.chain) - self._applied}"
                    f" steps unapplied, {len(missing)} chunks missing")
            target = self.chain[-1]
            out_flat: dict[str, torch.Tensor] = {}
            for key, a in _ckpt._flatten(like).items():
                a = _ckpt.as_tensor(a)
                entry = target["keys"][key]
                if entry.get("delta") is not None:
                    out_flat[key] = self._ref[key].reshape(
                        a.shape).to(a.dtype)
                else:
                    out_flat[key] = self.store.read_leaf(entry).to(
                        self.device)
            return _ckpt.unflatten_like(like, out_flat), target["meta"]


def chain_steps(store: ChunkStore, step: int) -> list[int]:
    """Steps of the delta chain ending at ``step``: [base, ..., step].
    A base/full manifest is its own one-element chain."""
    chain = []
    m = store.load_manifest(step)
    while True:
        chain.append(m["step"])
        if m["kind"] != "delta":
            return chain[::-1]
        m = store.load_manifest(m["prev_step"])


def restore(store: ChunkStore, like: Any, step: int | None = None, *,
            device="cuda") -> tuple[Any, dict]:
    """Replay base + deltas up to ``step`` on ``device``; bit-exact
    against the writer's reconstruction (verified via each manifest's
    ``ref_sha``). Returns (tree shaped/dtyped like ``like``, meta of
    ``step``). This is ``ChainReplayer`` run to completion: a streamed
    restore and a local one share every line."""
    if step is None:
        step = store.latest_step()
        if step is None:
            raise FileNotFoundError(f"no manifests under {store.root}")
    chain = [store.load_manifest(s) for s in chain_steps(store, step)]
    replayer = ChainReplayer(store, chain, device)
    replayer.advance()
    return replayer.finish(like)
