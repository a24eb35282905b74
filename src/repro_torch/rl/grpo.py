"""GRPO-style advantage estimation and the RL loss fed to the trainer
(port of ``repro.rl.grpo``).

Group Relative Policy Optimization (the INTELLECT-2 recipe): sample G
completions per prompt, normalize each completion's scalar reward
against its own group —

    A_i = (r_i - mean(r_group)) / std(r_group)

— no value network. Zero-variance groups (all completions scored the
same) carry no learning signal and are filtered rather than divided by
zero. The policy-gradient loss is token-level REINFORCE on the
completion span:

    L = - sum_t( A * w * mask_t * log pi(y_t | y_<t) ) / max(sum mask, 1)

where ``w`` is the staleness weight from the rollout buffer (1.0 under
mode='drop'). The loss plugs into ``ElasticTrainer`` unchanged: it has
the ``loss(params, batch) -> (loss, metrics)`` shape of the pretraining
cross-entropy over a different batch dict, and runs under autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.models.registry import ModelDef
from repro_torch.rl.buffer import Rollout


# -- rewards ------------------------------------------------------------------


def toy_low_token_reward(tokens: Sequence[int], vocab: int) -> float:
    """Toy verifiable reward: fraction of completion tokens drawn from
    the 'good' band [2, vocab//4). Band starts at 2 so eos (1) and pad
    (0) never score — otherwise the degenerate 'emit eos immediately'
    policy is optimal and the reward trend is unlearnable."""
    if not tokens:
        return 0.0
    lo, hi = 2, max(3, vocab // 4)
    good = sum(1 for t in tokens if lo <= int(t) < hi)
    return good / len(tokens)


def group_advantages(rewards: Sequence[float], groups: Sequence[int]
                     ) -> np.ndarray:
    """Per-group (r - mean) / std advantages; zero-variance groups map
    to all-zero advantages (filtered from the gradient, not div-by-0)."""
    rewards = np.asarray(rewards, np.float64)
    groups = np.asarray(groups)
    adv = np.zeros_like(rewards)
    for g in np.unique(groups):
        sel = groups == g
        r = rewards[sel]
        std = r.std()
        if std > 1e-8:
            adv[sel] = (r - r.mean()) / std
    return adv.astype(np.float32)


# -- loss ---------------------------------------------------------------------


class GRPOModel:
    """ModelDef-shaped wrapper whose ``loss`` is the GRPO REINFORCE
    objective over {"tokens", "targets", "mask", "adv"} batches.

    ``mask`` is 1.0 on completion positions (normalizer); ``adv`` is the
    per-token advantage*staleness-weight (signal). Prompt and padding
    positions are 0 in both, so the model is never trained to imitate
    the prompt."""

    def __init__(self, model: ModelDef):
        if model.logits is None:
            raise TypeError(
                f"family {model.cfg.family!r} exposes no bare logits "
                "forward — GRPO needs ModelDef.logits (dense / moe / "
                "vlm / ssm / hybrid)")
        self.inner = model
        self.cfg = model.cfg
        self.device = model.device
        self.init = model.init

    def loss(self, params, batch):
        logits = self.inner.logits(params, batch["tokens"])
        logp = torch.log_softmax(logits.float(), dim=-1)
        chosen = logp.gather(-1, batch["targets"].long()[..., None])[..., 0]
        mask = batch["mask"].float()
        denom = mask.sum().clamp_min(1.0)
        loss = -(batch["adv"] * mask * chosen).sum() / denom
        metrics = {"loss": loss,
                   "mean_logp": (mask * chosen).sum() / denom,
                   "tokens": mask.sum()}
        return loss, metrics


# -- batching -----------------------------------------------------------------


@dataclasses.dataclass
class GRPOExample:
    """One rollout rendered into trainer arrays (all length L)."""
    inp: np.ndarray     # (L,) int32: full[:-1] padded
    tgt: np.ndarray     # (L,) int32: full[1:] padded
    mask: np.ndarray    # (L,) f32: 1 on completion targets
    adv: np.ndarray     # (L,) f32: advantage * weight on completion


def render_example(r: Rollout, advantage: float, weight: float,
                   seq_len: int, pad_id: int = 0) -> GRPOExample:
    """prompt+completion -> next-token arrays. Completion targets sit
    at positions [len(prompt)-1, len(prompt)-1+len(tokens)) of the
    shifted sequence; anything past seq_len is truncated."""
    full = np.concatenate([np.asarray(r.prompt, np.int32),
                           np.asarray(r.tokens, np.int32)])
    inp, tgt = full[:-1], full[1:]
    n = min(len(inp), seq_len)
    out_i = np.full(seq_len, pad_id, np.int32)
    out_t = np.full(seq_len, pad_id, np.int32)
    out_i[:n], out_t[:n] = inp[:n], tgt[:n]
    mask = np.zeros(seq_len, np.float32)
    lo = len(r.prompt) - 1
    hi = min(lo + len(r.tokens), seq_len)
    if hi > lo >= 0:
        mask[lo:hi] = 1.0
    return GRPOExample(out_i, out_t, mask,
                       mask * np.float32(advantage * weight))


class GRPOBatcher:
    """``ElasticTrainer.batch_provider`` backed by a pool of rendered
    rollouts.

    ``ingest()`` replaces the pool with the latest drained-and-scored
    rollouts; the provider cycles the pool deterministically (cursor
    mod pool size) to fill (H, k, b, L) stacks (CPU tensors; the
    trainer moves them to its device). When no rollouts have arrived
    yet (starved), it reuses the previous pool rather than stalling the
    trainer — with an all-zero fallback example before the first
    ingest, which contributes zero gradient."""

    def __init__(self, seq_len: int, batch_per_worker: int,
                 pad_id: int = 0):
        self.seq_len = int(seq_len)
        self.b = int(batch_per_worker)
        self.pad_id = pad_id
        z = np.zeros(self.seq_len, np.float32)
        zi = np.full(self.seq_len, pad_id, np.int32)
        self._pool: list[GRPOExample] = [GRPOExample(zi, zi, z, z)]
        self._cursor = 0
        self.starved_phases = 0
        self.ingested = 0

    def ingest(self, scored: Sequence[tuple[Rollout, float, float]]
               ) -> int:
        """Replace the pool. ``scored`` is (rollout, advantage, weight)
        triples; zero-advantage examples still enter the pool (they
        hold the normalizer honest) unless the whole batch is empty."""
        pool = [render_example(r, a, w, self.seq_len, self.pad_id)
                for r, a, w in scored]
        if pool:
            self._pool = pool
            self._cursor = 0
            self.ingested += len(pool)
        return len(pool)

    def __call__(self, global_step: int, h: int, k: int):
        if self.ingested == 0:
            self.starved_phases += 1
        need = h * k * self.b
        exs = []
        for _ in range(need):
            exs.append(self._pool[self._cursor % len(self._pool)])
            self._cursor += 1
        shape = (h, k, self.b, self.seq_len)

        def stack(key):
            return torch.from_numpy(
                np.stack([getattr(e, key) for e in exs]).reshape(shape))
        return {"tokens": stack("inp"), "targets": stack("tgt"),
                "mask": stack("mask"), "adv": stack("adv")}
