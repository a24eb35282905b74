"""Trainer-side policy publication for the async RL tier (port of
``repro.rl.policy_pub``).

At each outer boundary the trainer's fresh anchor becomes a **policy
version**: the :class:`PolicyPublisher` ships it as one link of a
quantized delta-checkpoint chain (``DeltaCheckpointer`` over a
``ChunkStore``) and serves it to rollout workers through a
:class:`PolicyPeer` (the swarm chunk protocol plus a ``policy_sha``
op). Versions are consecutive integers, reused as the chain's step
numbers.

Bit-exactness contract: the published policy IS the writer's
reconstruction (``DeltaCheckpointer.reference`` at publish time, which
for base versions equals the raw anchor exactly). Its tree sha is
recorded at publish; a worker that adopts version v must reproduce that
sha bit-for-bit — the delta chain guarantees it, and the driver/tests
assert it on every adoption.

Retention vs the lagging consumer (the race this module closes): the
publisher pins each live version's chain at publish time, so
``retire()``'s gc can never collect a version a slow worker may still
request — and a worker *mid-stream* on a retiring version is protected
a second time by the peer's per-session chain pin. Only a **forced**
retire tombstones the version (``ChunkStore.retire_step``), after
which a fetch fails with the typed :class:`PolicyRetiredError` (via
``StepRetiredError``) instead of hanging or serving a truncated chain —
the worker's signal to re-adopt the latest version.

The writer's reference lives on the publisher's ``device``: on CUDA each
int8 delta is encoded by the codec's ``pseudograd_encode_hist`` kernel
and applied to the reference by its ``decode_add`` kernel, once per
float leaf (``checkpointing.delta``).
"""
from __future__ import annotations

import hashlib
import json
from typing import Any

from repro_torch.checkpointing import checkpoint as _ckpt
from repro_torch.checkpointing import (ChunkStore, DeltaCheckpointer,
                                       DeltaConfig, StepRetiredError)
from repro_torch.checkpointing.delta import chain_steps
from repro_torch.checkpointing.swarm import ChunkPeer, _send_frame


class PolicyRetiredError(StepRetiredError):
    """The requested policy version was force-retired by the trainer:
    terminal for that version — re-adopt the latest instead."""


def tree_sha(tree: Any) -> str:
    """Order-stable sha256 over a tree's leaves (key, shape, dtype name,
    raw bytes) — the adoption bit-exactness witness. The same bytes as
    ``repro.rl.policy_pub.tree_sha`` hashes for the same tree (numpy's
    shape string and dtype name; bf16 as its raw bits)."""
    h = hashlib.sha256()
    for key in sorted(flat := _ckpt._flatten(tree)):
        arr, dtype = _ckpt.host_array(flat[key])
        h.update(key.encode())
        h.update(str(arr.shape).encode())
        h.update(dtype.encode())
        h.update(arr.tobytes())
    return h.hexdigest()


class PolicyPeer(ChunkPeer):
    """ChunkPeer + ``{"op": "policy_sha", "version": v}`` -> the
    publisher-recorded reconstruction sha (or ``{"error":
    "unknown-version"}``), so workers verify adoption end-to-end over
    the wire rather than via in-process back-channels."""

    def __init__(self, store: ChunkStore, publisher: "PolicyPublisher",
                 **kw):
        self.publisher = publisher
        super().__init__(store, **kw)

    def _handle_op(self, conn, req, pins) -> bool:
        if req.get("op") == "policy_sha":
            sha = self.publisher.shas.get(int(req["version"]))
            body = {"sha": sha} if sha else \
                {"error": "unknown-version", "version": req["version"]}
            _send_frame(conn, json.dumps(body).encode())
            return True
        return super()._handle_op(conn, req, pins)


class PolicyPublisher:
    """Publishes trainer anchors as a delta chain of policy versions.

    ``keep_live`` bounds how many versions stay fetchable: publishing
    version v auto-retires (unforced) versions <= v - keep_live. An
    unforced retire only unpins + gcs — the chain-keeping gc and any
    consumer-session pins decide what physically survives. Forced
    retire additionally tombstones the version. The delta writer's
    reference lives on ``device``.
    """

    def __init__(self, store: ChunkStore | str, *, codec: str = "int8",
                 base_every: int = 8, keep_live: int = 4, device="cuda"):
        self.store = store if isinstance(store, ChunkStore) \
            else ChunkStore(store)
        self.writer = DeltaCheckpointer(
            self.store, DeltaConfig(base_every=base_every, codec=codec),
            device=device)
        self.keep_live = int(keep_live)
        self.shas: dict[int, str] = {}      # version -> reconstruction sha
        self._pins: dict[int, dict] = {}    # version -> gc pin token
        self.latest: int | None = None
        self.retired: list[int] = []

    @property
    def live_versions(self) -> list[int]:
        return sorted(self._pins)

    def publish(self, version: int, tree: Any,
                meta: dict | None = None) -> dict:
        version = int(version)
        assert self.latest is None or version > self.latest, \
            f"versions must be monotone: {version} after {self.latest}"
        manifest = self.writer.save(
            version, tree, {"policy_version": version, **(meta or {})})
        # the publish-time reconstruction is the contract: what every
        # adopter must reproduce (== tree exactly for base versions)
        self.shas[version] = tree_sha(self.writer.reference(tree))
        self._pins[version] = self.store.pin_chain(version)
        self.latest = version
        rec = {"version": version, "kind": manifest["kind"],
               "sha": self.shas[version],
               "new_bytes": manifest["stats"]["new_bytes"],
               "logical_bytes": manifest["stats"]["logical_bytes"]}
        floor = version - self.keep_live
        for old in [v for v in self.live_versions if v <= floor]:
            self.retire(old)
        rec["live"] = self.live_versions
        return rec

    def safe_to_retire(self, version: int) -> bool:
        """True unless ``version`` is a chain link of a DIFFERENT live
        version: tombstoning a live chain's base/prev would make every
        dependent version unrestorable even though it is still pinned
        (the chain walk hits the tombstone mid-fetch)."""
        return not any(version in chain_steps(self.store, v)
                       for v in self.live_versions if v != version)

    def retire(self, version: int, *, force: bool = False) -> dict:
        """Withdraw ``version`` from retention. Unforced: drop its pin
        and gc — chunks shared with kept chains and chunks pinned by an
        in-flight consumer session all survive. Forced: also tombstone
        it so future fetches fail typed (PolicyRetiredError at the
        worker) instead of racing the gc; refused when the version is a
        chain dependency of a live one."""
        version = int(version)
        if force and not self.safe_to_retire(version):
            raise ValueError(
                f"version {version} is a chain link of live versions "
                f"{self.live_versions} — tombstoning it would sever "
                "their delta chains")
        token = self._pins.pop(version, None)
        if token is not None:
            self.store.unpin(token)
        if force:
            self.store.retire_step(version)
        self.retired.append(version)
        stats = self.store.gc(keep_steps=tuple(self._pins))
        return {"version": version, "forced": force, "gc": stats}

    def serve(self, port: int = 0) -> PolicyPeer:
        return PolicyPeer(self.store, self, port=port)
