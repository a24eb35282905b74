"""End-to-end asynchronous decentralized RL driver (INTELLECT-2 shape;
port of ``repro.rl.driver``).

One process plays every role so the whole protocol is testable on CPU,
mirroring how ``ElasticTrainer`` simulates the DiLoCo cluster:

    trainer (ElasticTrainer + GRPO loss)
        └─ boundary_hook ──> PolicyPublisher ──> delta chain v0,v1,...
                                   │ PolicyPeer (swarm protocol)
    rollout workers (ContinuousEngine, capture_logprobs)
        └─ adopt(v) on their own cadence ──> generate ──> RolloutBuffer
                                   │
    outer boundary: drain(staleness window) -> rewards -> GRPO
    advantages -> GRPOBatcher -> next inner phase's batches

Per outer step t: (churn) -> workers adopt on their stride -> generate
one round of grouped completions -> drain the buffer against the
CURRENT version (staleness ledger) -> score + group-normalize -> ingest
into the batcher -> ``trainer.run(1)`` (whose boundary hook publishes
version t+1). Version t is therefore always one boundary ahead of the
freshest rollout that can train on it — the async lag is structural,
not an artifact.

Every role runs on ``RLConfig.device`` (the trainer, the publisher's
delta reference and the workers' engines): on CUDA the GRPO trainer's
int8 ring runs the codec kernels, each policy delta is encoded and
applied by them, and the rollouts decode through the flash-decode
kernels (the paged one for a worker whose engine is ``"paged"``,
``RLConfig.engines``). ``reduced`` / ``n_layers`` size the model as
``launch.train``'s ``--reduced`` / ``--n-layers`` do; the defaults are
the JAX package's (the reduced preset, every worker continuous).
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import diloco as dl
from repro_torch.core.fault_tolerance import ClusterSimulator
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.registry import get_model
from repro_torch.rl.buffer import RolloutBuffer
from repro_torch.rl.grpo import (GRPOBatcher, GRPOModel, group_advantages,
                                 toy_low_token_reward)
from repro_torch.rl.policy_pub import PolicyPublisher, PolicyRetiredError
from repro_torch.rl.rollout import RolloutWorker
from repro_torch.train.loop import ElasticTrainer, TrainerConfig


PAGED_BLOCK = 16          # a paged rollout worker's KV block (cells)


@dataclasses.dataclass
class RLConfig:
    arch: str = "internlm2-1.8b"   # reduced() of this preset
    reduced: bool = True           # False: the preset's full width
    n_layers: int | None = None    # cut the depth (full width kept)
    device: str = "cuda"
    # worker i's engine: engines[i % len] ('continuous' | 'paged')
    engines: tuple = ("continuous",)
    n_workers: int = 2
    outer_steps: int = 6
    inner_steps: int = 2
    trainer_workers: int = 2       # DiLoCo slots in the stacked sim
    batch_per_worker: int = 2
    seq_len: int = 32
    n_groups: int = 4              # GRPO groups per outer step
    group_size: int = 4            # completions per group
    prompt_len: int = 6
    max_new: int = 10
    temperature: float = 1.0
    inner_lr: float = 5e-3
    max_policy_lag: int = 1
    stale_mode: str = "drop"       # 'drop' | 'downweight'
    stale_gamma: float = 0.5
    codec: str = "int8"            # policy delta chain codec
    base_every: int = 4
    keep_live: int = 4
    # worker i re-adopts every adopt_strides[i % len] outer steps; a
    # stride above max_policy_lag+1 makes that worker's tail rollouts
    # provably stale (the ledger must show the drops)
    adopt_strides: tuple = (1, 3)
    kill_at: int | None = None     # outer step to crash kill_worker
    rejoin_at: int | None = None
    kill_worker: int = 1
    force_retire_at: int | None = None  # tombstone the oldest version
    seed: int = 0


class RLDriver:
    """Builds the fleet under ``root`` (publisher store + one store per
    worker) and runs the async RL loop. ``run()`` returns a summary the
    benchmark/launcher serialize directly."""

    def __init__(self, cfg: RLConfig, root: str | pathlib.Path):
        assert cfg.prompt_len + cfg.max_new <= cfg.seq_len + 1, \
            "rollouts longer than the training seq_len would truncate"
        self.cfg = cfg
        self.root = pathlib.Path(root)
        arch = get_config(cfg.arch)
        if cfg.reduced:
            arch = arch.reduced()
        if cfg.n_layers is not None:
            arch = dataclasses.replace(arch, n_layers=cfg.n_layers)
        self.arch = arch
        self.model = get_model(arch, cfg.device)
        params = self.model.init(cfg.seed)
        self.publisher = PolicyPublisher(
            str(self.root / "pub"), codec=cfg.codec,
            base_every=cfg.base_every, keep_live=cfg.keep_live,
            device=cfg.device)
        self.peer = self.publisher.serve()
        self.peers = [self.peer.addr]
        self.workers = [self._worker(i, params)
                        for i in range(cfg.n_workers)]
        self.buffer = RolloutBuffer()
        self.batcher = GRPOBatcher(cfg.seq_len, cfg.batch_per_worker)
        dcfg = DataConfig(vocab=arch.vocab, seq_len=cfg.seq_len,
                          batch_per_worker=cfg.batch_per_worker,
                          total_steps=cfg.outer_steps * cfg.inner_steps)
        tcfg = TrainerConfig(
            diloco=dl.DiLoCoConfig(inner_steps=cfg.inner_steps,
                                   quant="int8"),
            inner_lr=cfg.inner_lr, max_workers=cfg.trainer_workers)
        self.trainer = ElasticTrainer(
            GRPOModel(self.model), tcfg, dcfg, params,
            ClusterSimulator(list(range(cfg.trainer_workers))),
            batch_provider=self.batcher,
            boundary_hook=self._publish_hook)
        # v0: the initial anchor, published before any rollout so the
        # fleet never samples from an unpublished policy
        self._published = 0
        self.publisher.publish(0, {"params": self.trainer.outer.anchor})
        self.step_recs: list[dict] = []
        self.retired_fallbacks = 0
        self.sha_failures = 0

    def _worker(self, i: int, params) -> RolloutWorker:
        cfg = self.cfg
        max_len = cfg.prompt_len + cfg.max_new + 2
        engine = cfg.engines[i % len(cfg.engines)]
        kw = {}
        if engine == "paged":
            # the paged cache's width is whole blocks
            max_len = -(-max_len // PAGED_BLOCK) * PAGED_BLOCK
            kw["block_size"] = PAGED_BLOCK
        return RolloutWorker(i, self.model, params,
                             str(self.root / f"worker{i}"), max_len=max_len,
                             seed=cfg.seed, engine=engine, **kw)

    # -- trainer boundary -> policy version -----------------------------------

    def _publish_hook(self, t: int, trainer) -> dict:
        self._published += 1
        return self.publisher.publish(
            self._published, {"params": trainer.outer.anchor},
            meta={"outer_step": t})

    # -- rollout round --------------------------------------------------------

    def _prompts(self, t: int) -> list[tuple[np.ndarray, int]]:
        """(prompt, group) pairs for step t: each group shares ONE
        prompt (GRPO's baseline is within-group), drawn from [2, vocab)
        so pad/eos never appear mid-prompt. Deterministic in (seed, t)."""
        out = []
        for g in range(self.cfg.n_groups):
            rng = np.random.default_rng(
                (self.cfg.seed * 100003 + t * 131 + g) % (2**31))
            p = rng.integers(2, self.arch.vocab, size=self.cfg.prompt_len,
                             dtype=np.int64).astype(np.int32)
            out.extend([(p, g)] * self.cfg.group_size)
        return out

    def _rollout_round(self, t: int) -> dict:
        alive = [w for w in self.workers if w.alive]
        assert alive, "entire rollout fleet is dead"
        work = self._prompts(t)
        shares = {w.wid: [] for w in alive}
        for i, item in enumerate(work):
            shares[alive[i % len(alive)].wid].append(item)
        stats = []
        for w in alive:
            if not shares[w.wid]:
                continue
            prompts = [p for p, _ in shares[w.wid]]
            groups = [g for _, g in shares[w.wid]]
            rollouts, st = w.generate(
                prompts, groups=groups, max_new=self.cfg.max_new,
                temperature=self.cfg.temperature)
            self.buffer.add(rollouts)
            stats.append(st)
        return {"workers": stats,
                "tokens": sum(s["tokens"] for s in stats),
                "wall_s": sum(s["wall_s"] for s in stats)}

    # -- one outer step -------------------------------------------------------

    def _adopt_round(self, t: int) -> list[dict]:
        recs = []
        strides = self.cfg.adopt_strides
        for i, w in enumerate(self.workers):
            if not w.alive:
                continue
            stride = max(1, strides[i % len(strides)])
            if t % stride == 0 or w.version is None:
                rec = w.adopt(self.peers)
                if not rec["sha_verified"]:
                    self.sha_failures += 1
                recs.append(rec)
        return recs

    def _maybe_churn(self, t: int) -> dict:
        c, rec = self.cfg, {}
        if c.kill_at is not None and t == c.kill_at:
            self.workers[c.kill_worker].kill()
            rec["killed"] = c.kill_worker
        if c.rejoin_at is not None and t == c.rejoin_at and \
                not self.workers[c.kill_worker].alive:
            self.workers[c.kill_worker].rejoin(self.peers)
            rec["rejoined"] = c.kill_worker
        if c.force_retire_at is not None and t == c.force_retire_at:
            # oldest live version that is NOT a chain link of a newer
            # one (the publisher refuses to tombstone chain links)
            safe = [v for v in self.publisher.live_versions[:-1]
                    if self.publisher.safe_to_retire(v)]
            if not safe:
                rec["force_retired"] = None
                return rec
            old = safe[0]
            self.publisher.retire(old, force=True)
            rec["force_retired"] = old
            # a lagging consumer asking for the tombstoned version must
            # get the typed terminal error, then recover on the latest
            try:
                self.workers[0].adopt(self.peers, version=old)
            except PolicyRetiredError:
                self.retired_fallbacks += 1
                self.workers[0].adopt(self.peers)
            else:
                raise AssertionError(
                    f"adopting retired v{old} did not raise")
        return rec

    def step(self, t: int) -> dict:
        rec = {"outer_step": t, "churn": self._maybe_churn(t)}
        rec["adoptions"] = self._adopt_round(t)
        rec["rollout"] = self._rollout_round(t)
        current = self.publisher.latest
        drained = self.buffer.drain(
            current, self.cfg.max_policy_lag, mode=self.cfg.stale_mode,
            stale_gamma=self.cfg.stale_gamma)
        rewards = [toy_low_token_reward(r.tokens, self.arch.vocab)
                   for r, _ in drained]
        for (r, _), rew in zip(drained, rewards):
            r.reward = rew
        advs = group_advantages(rewards, [r.group for r, _ in drained])
        self.batcher.ingest(
            [(r, float(a), w) for (r, w), a in zip(drained, advs)])
        lags = [current - r.version for r, _ in drained]
        rec["train"] = self.trainer.run(1)[-1]
        rec.update(
            version=current,
            mean_reward=float(np.mean(rewards)) if rewards else 0.0,
            accepted=len(drained),
            mean_accepted_lag=float(np.mean(lags)) if lags else 0.0,
            loss=rec["train"]["loss"])
        self.step_recs.append(rec)
        return rec

    # -- full run -------------------------------------------------------------

    def run(self) -> dict:
        for t in range(self.cfg.outer_steps):
            self.step(t)
        return self.summary()

    def summary(self) -> dict:
        led = self.buffer.ledger.as_dict()
        rounds = [r["rollout"] for r in self.step_recs]
        tok = sum(r["tokens"] for r in rounds)
        wall = sum(r["wall_s"] for r in rounds)
        adopts = [a for r in self.step_recs for a in r["adoptions"]]
        rewards = [r["mean_reward"] for r in self.step_recs]
        return {
            "outer_steps": len(self.step_recs),
            "versions_published": self._published + 1,
            "reward_trend": rewards,
            "reward_first": rewards[0] if rewards else None,
            "reward_last": rewards[-1] if rewards else None,
            "loss_trend": [r["loss"] for r in self.step_recs],
            "ledger": led,
            "stale_drop_fraction":
                led["dropped_stale"] / max(1, led["generated"]),
            "mean_accepted_lag": float(np.mean(
                [r["mean_accepted_lag"] for r in self.step_recs]))
                if self.step_recs else 0.0,
            "rollout_tok_s": tok / wall if wall > 0 else 0.0,
            "rollout_tokens": tok,
            "adoptions": len(adopts),
            "mean_adopt_s": float(np.mean(
                [a["adopt_s"] for a in adopts])) if adopts else 0.0,
            "adopt_bytes": sum(a["bytes_fetched"] for a in adopts),
            "bit_exact": self.sha_failures == 0 and
                all(a["sha_verified"] for a in adopts),
            "retired_fallbacks": self.retired_fallbacks,
            "live_versions": self.publisher.live_versions,
            "starved_phases": self.batcher.starved_phases,
        }

    def close(self) -> None:
        self.peer.close()
