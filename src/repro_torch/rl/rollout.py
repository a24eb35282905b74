"""Rollout workers: the serving tier feeding the RL trainer (port of
``repro.rl.rollout``).

A :class:`RolloutWorker` is a node that (1) **adopts** a published
policy version over the swarm chunk protocol — fetch the delta chain
into its own ``ChunkStore``, replay it bit-exactly, verify the tree sha
against the publisher's record — and (2) **generates** rollouts with a
``ContinuousEngine`` (or ``PagedEngine``) in ``capture_logprobs`` mode,
so every sampled token carries its behaviour-policy log-prob for the
GRPO loss.

Adoption is asynchronous by design: each worker re-adopts on its own
cadence, so at any instant the fleet spans several policy versions.
Rollouts are tagged with the version that generated them; the staleness
window in :class:`repro_torch.rl.buffer.RolloutBuffer` is what keeps
that spread bounded on the training side.

Failure model: a killed worker just stops producing (its buffer
contributions age out of the staleness window); a rejoiner re-adopts
from whatever peers are alive — its local store dedups the chain prefix
it already holds, so a rejoin fetches only the deltas it missed. A
worker that requests a force-retired version gets the typed
:class:`PolicyRetiredError` and re-adopts the latest.

Device route: the chain replays on the model's device (on CUDA each
delta through the codec's ``decode_add`` kernel, once per float leaf).
The restore takes the published leaves' own dtypes from the manifest,
so the sha check holds whatever ``like``'s dtypes are; the engine then
serves the policy cast to ``like``'s dtypes (a bf16 model serves the
bf16 rounding of the fp32 anchor the trainer publishes). Rollouts
drain through the engine's ``_waiting()``, which also counts requests
prefilled ahead of a slot.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.checkpointing import ChunkStore, StepRetiredError, swarm_fetch
from repro_torch.checkpointing import checkpoint as _ckpt
from repro_torch.checkpointing import delta as _delta
from repro_torch.checkpointing.p2p import PeerConn
from repro_torch.rl.buffer import Rollout
from repro_torch.rl.policy_pub import PolicyRetiredError, tree_sha
from repro_torch.serving.engine import ContinuousEngine, Request


class AdoptionShaMismatch(RuntimeError):
    """The restored policy does not reproduce the publisher's recorded
    reconstruction sha — the chain replay is NOT bit-exact."""


class RolloutWorker:
    """One inference node of the asynchronous rollout fleet.

    ``like`` is a params tree (shapes, and the dtypes the engine serves,
    e.g. the init params the trainer started from). The engine is built
    on first adoption and kept across re-adoptions (params swap in
    place)."""

    def __init__(self, wid: int, model, like, store_root, *,
                 batch_slots: int = 4, max_len: int = 256,
                 decode_chunk: int = 8, seed: int = 0, eos_id: int = 1,
                 engine: str = "continuous", **engine_kw):
        self.wid = int(wid)
        self.model = model
        self.device = model.device
        self.like = like
        self.store = ChunkStore(store_root)
        # engine="paged" serves GRPO groups off the paged KV tier: the
        # k samples of a group share their question prompt, so the
        # content-addressed prefix index maps all k to the same
        # physical blocks and k-1 prefills are skipped outright
        self.engine_kind = engine
        self.engine_kw = dict(batch_slots=batch_slots, max_len=max_len,
                              decode_chunk=decode_chunk, eos_id=eos_id,
                              seed=seed * 1009 + wid, **engine_kw)
        self.engine: ContinuousEngine | None = None
        self.version: int | None = None     # adopted policy version
        self.adopted_sha: str | None = None
        self.adoptions: list[dict] = []
        self.alive = True
        self._rid = 0

    # -- policy adoption ------------------------------------------------------

    def _published_like(self, manifest: dict) -> dict:
        """``{"params": like}`` with the published leaves' dtypes (meta
        tensors: a restore template, no storage)."""
        flat = _ckpt._flatten({"params": self.like})
        out = {}
        for key, leaf in flat.items():
            dtype = _ckpt.resolve_dtype(manifest["keys"][key]["dtype"])
            out[key] = torch.empty(tuple(leaf.shape), dtype=dtype,
                                   device="meta")
        return _ckpt.unflatten_like({"params": self.like}, out)

    def _serving_params(self, tree: dict) -> dict:
        """The restored policy on the model's device in ``like``'s
        dtypes."""
        flat = _ckpt._flatten(tree["params"])
        like = _ckpt._flatten(self.like)
        return _ckpt.unflatten_like(self.like, {
            k: t.to(self.device, like[k].dtype) for k, t in flat.items()})

    def adopt(self, peers: Sequence[tuple], *,
              version: int | None = None, timeout: float = 20.0) -> dict:
        """Fetch + restore policy ``version`` (None = the peers'
        newest) and swap it into the engine. Returns the adoption
        record; raises :class:`PolicyRetiredError` when the version was
        force-retired and :class:`AdoptionShaMismatch` when the restore
        is not bit-exact vs the publisher."""
        t0 = time.perf_counter()
        try:
            stats = swarm_fetch(peers, self.store, step=version,
                                timeout=timeout)
        except PolicyRetiredError:
            raise
        except StepRetiredError as e:
            raise PolicyRetiredError(str(e), e.failures) from e
        v = stats["step"]
        manifest = self.store.load_manifest(v)
        like = self._published_like(manifest)
        if manifest["kind"] == "delta":
            tree, meta = _delta.restore(self.store, like, step=v,
                                        device=self.device)
        else:
            tree, meta = self.store.restore_tree(like, step=v,
                                                 device=self.device)
        sha = tree_sha(tree)
        pub_sha = self._publisher_sha(peers, v, timeout)
        if pub_sha is not None and pub_sha != sha:
            raise AdoptionShaMismatch(
                f"worker {self.wid}: adopted v{v} sha {sha[:12]} != "
                f"published {pub_sha[:12]}")
        params = self._serving_params(tree)
        del tree
        if self.engine is None:
            if self.engine_kind == "paged":
                from repro_torch.serving.paging import PagedEngine
                self.engine = PagedEngine(
                    self.model, params, capture_logprobs=True,
                    **self.engine_kw)
            else:
                self.engine = ContinuousEngine(
                    self.model, params, capture_logprobs=True,
                    **self.engine_kw)
        else:
            self.engine.params = params
            # cached prefix KV / logits were computed under the OLD
            # policy — a params swap must invalidate the sharing index
            flush = getattr(self.engine, "flush_prefix_cache", None)
            if flush is not None:
                flush()
        prev = self.version
        self.version = int(meta.get("policy_version", v))
        self.adopted_sha = sha
        rec = {"worker": self.wid, "version": self.version,
               "from_version": prev, "sha": sha,
               "sha_verified": pub_sha is not None,
               "chunks_fetched": stats["chunks_fetched"],
               "bytes_fetched": stats["bytes_fetched"],
               "adopt_s": time.perf_counter() - t0}
        self.adoptions.append(rec)
        return rec

    def _publisher_sha(self, peers, version: int,
                       timeout: float) -> str | None:
        """Ask any peer for the publisher-recorded sha of ``version``
        (None when no peer speaks the policy_sha op — plain ChunkPeers
        serving a checkpoint store)."""
        for addr in peers:
            try:
                conn = PeerConn(tuple(addr), timeout)
                try:
                    body = conn.request_json(
                        {"op": "policy_sha", "version": int(version)})
                finally:
                    conn.close()
                if body.get("sha"):
                    return body["sha"]
            except Exception:
                continue
        return None

    # -- generation -----------------------------------------------------------

    def generate(self, prompts: Sequence[np.ndarray], *,
                 groups: Sequence[int] | None = None,
                 max_new: int = 16,
                 temperature: float = 1.0) -> tuple[list[Rollout], dict]:
        """Sample one completion per prompt (prompts sharing a group id
        form one GRPO group). Returns (rollouts tagged with the adopted
        version, worker-side stats)."""
        assert self.engine is not None and self.version is not None, \
            f"worker {self.wid} has not adopted a policy yet"
        assert self.alive, f"worker {self.wid} is dead"
        if groups is None:
            groups = list(range(len(prompts)))
        reqs = []
        for p in prompts:
            self._rid += 1
            reqs.append(Request(
                rid=self.wid * 1_000_000 + self._rid,
                prompt=np.asarray(p, np.int32),
                max_new_tokens=max_new, temperature=temperature))
        t0 = time.perf_counter()
        for r in reqs:
            self.engine.submit(r)
        self.engine.run_until_drained()
        wall = time.perf_counter() - t0
        rollouts = []
        for r, g in zip(reqs, groups):
            assert len(r.out_logprobs) == len(r.out_tokens), \
                "logprob capture out of sync with emitted tokens"
            rollouts.append(Rollout(
                rid=r.rid, prompt=np.asarray(r.prompt, np.int32),
                tokens=list(r.out_tokens),
                logprobs=list(r.out_logprobs),
                version=self.version, group=int(g), worker=self.wid))
        n_tok = sum(len(r.out_tokens) for r in reqs)
        stats = {"worker": self.wid, "version": self.version,
                 "requests": len(reqs), "tokens": n_tok,
                 "wall_s": wall,
                 "tokens_per_s": n_tok / wall if wall > 0 else 0.0}
        return rollouts, stats

    # -- fault injection ------------------------------------------------------

    def kill(self) -> None:
        """Simulated crash: the worker stops producing until rejoin."""
        self.alive = False

    def rejoin(self, peers, *, timeout: float = 20.0) -> dict:
        """Come back from a crash: re-adopt the latest policy (the
        local store dedups whatever chain prefix survived)."""
        self.alive = True
        return self.adopt(peers, timeout=timeout)
