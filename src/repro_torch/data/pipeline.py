"""Deterministic, shardable token pipeline with mixture weights and
annealing re-weighting (port of ``repro.data.pipeline``; paper §3.1,
§3.4, Table 1).

INTELLECT-1 trained on a five-source mixture (FineWeb-Edu 55%, FineWeb
10%, StackV1 20%, DCLM 10%, OpenWebMath 5%), re-weighted for the final
20% (80/10/10/0/0). Sources are synthetic token streams (per-source Zipf
skew, the source id as marker token 0), and every DiLoCo worker reads
its own shard.

The contract is the reference's; the random stream is not. JAX draws
from threefry keys, which torch cannot reproduce, so this stream is
numpy's counter-based Philox keyed by (seed, worker, step): ``batch_at``
is a pure function of those, workers get disjoint streams, and any
worker can replay any shard. Tests that compare the two packages feed
the same batches through the trainer's ``batch_provider``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    name: str
    weight: float              # stable-phase mixture weight
    anneal_weight: float       # annealing-phase weight
    zipf_a: float = 1.2        # token-distribution skew (synthetic)


INTELLECT1_MIX = (
    SourceSpec("fineweb-edu", 0.55, 0.80, 1.10),
    SourceSpec("fineweb", 0.10, 0.10, 1.15),
    SourceSpec("stack-v1", 0.20, 0.10, 1.30),
    SourceSpec("dclm-baseline", 0.10, 0.00, 1.20),
    SourceSpec("openwebmath", 0.05, 0.00, 1.25),
)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_per_worker: int
    sources: tuple = INTELLECT1_MIX
    anneal_start_frac: float = 0.8     # paper: final 20% anneals
    total_steps: int = 10_000
    seed: int = 0


class TokenPipeline:
    """Counter-based synthetic pipeline; one instance per DiLoCo worker.

    ``batch_at(step)`` -> {"tokens", "targets", "mask"} (CPU tensors:
    int32, int32, fp32) for this worker's shard at that step."""

    def __init__(self, cfg: DataConfig, worker: int, n_workers: int):
        self.cfg = cfg
        self.worker = worker
        self.n_workers = n_workers
        w = np.array([s.weight for s in cfg.sources], np.float64)
        self._w = w / w.sum()
        aw = np.array([s.anneal_weight for s in cfg.sources], np.float64)
        self._aw = aw / max(aw.sum(), 1e-9)
        self._zipf = np.array([s.zipf_a for s in cfg.sources], np.float64)

    def mixture_at(self, step: int) -> np.ndarray:
        if step >= self.cfg.anneal_start_frac * self.cfg.total_steps:
            return self._aw
        return self._w

    def _rng(self, step: int) -> np.random.Generator:
        """Philox keyed by (seed, worker, step): no state carried."""
        key = np.random.SeedSequence(
            [self.cfg.seed, self.worker, step]).generate_state(2, np.uint64)
        return np.random.Generator(np.random.Philox(key=key))

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, worker, step)."""
        cfg = self.cfg
        rng = self._rng(step)
        src = rng.choice(len(cfg.sources), size=cfg.batch_per_worker,
                         p=self.mixture_at(step))
        u = rng.uniform(1e-6, 1.0, size=(cfg.batch_per_worker,
                                         cfg.seq_len + 1))
        ranks = np.floor(u ** (-1.0 / self._zipf[src][:, None])) \
            % (cfg.vocab - 8)
        tokens = (ranks + 8).astype(np.int32)
        tokens[:, 0] = src                    # source marker
        tokens = torch.from_numpy(tokens)
        return {"tokens": tokens[:, :-1].contiguous(),
                "targets": tokens[:, 1:].contiguous(),
                "mask": torch.ones((cfg.batch_per_worker, cfg.seq_len),
                                   dtype=torch.float32)}
