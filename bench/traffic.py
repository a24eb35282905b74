"""The one generator of training traffic, driven by a traffic file.

A traffic file (``bench/traffic/<mix>.json``) fixes the job: the number
of DiLoCo workers (one stacked slot each), the inner steps H between outer
syncs, the rows and the sequence length of a worker-step, the token
law, the optimizers' settings, the outer sync's codec and the outer
steps the correctness check follows. This module makes the token rows
of every (worker, step) from the run's seed, on the device, in a few
large calls: ids of rank r are drawn with probability proportional to
r ** -zipf_exponent over the vocabulary (an exponent of 0 draws every
id alike), and a permutation of the vocabulary drawn from the seed
maps ranks to ids. Rows of one global step are one draw, so every row
of every worker and step differs.
"""
from __future__ import annotations

import torch

from bench.seeds import derive


class Tokens:
    """Token rows of a run: ``rows(step)`` -> (workers, B, S + 1) int32
    on the device."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        self.t = traffic
        self.seed = seed
        self.device = torch.device(device)
        g = torch.Generator(device=self.device).manual_seed(
            derive(seed, "vocab"))
        self.ids = torch.randperm(vocab, generator=g, device=self.device)
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64,
                             device=self.device)
        cdf = torch.cumsum(ranks ** -float(traffic["zipf_exponent"]), 0)
        self.cdf = cdf / cdf[-1]

    def rows(self, step: int) -> torch.Tensor:
        t = self.t
        shape = (t["workers"], t["rows_per_worker_step"], t["seq_len"] + 1)
        g = torch.Generator(device=self.device).manual_seed(
            derive(self.seed, "tokens", step))
        u = torch.rand(shape, generator=g, dtype=torch.float64,
                       device=self.device)
        r = torch.searchsorted(self.cdf, u).clamp_max(self.cdf.numel() - 1)
        return self.ids[r].to(torch.int32)

    def outer_step(self, first: int, h: int) -> torch.Tensor:
        """(h, workers, B, S + 1): the rows of global steps first ..
        first + h - 1."""
        return torch.stack([self.rows(first + i) for i in range(h)])

    def provider(self):
        """The trainer's ``batch_provider(global_step, h, k)``: inputs,
        targets and mask of every worker, (h, k, B, S) each."""
        def batches(global_step: int, h: int, k: int) -> dict:
            if k != self.t["workers"]:
                raise ValueError(f"{k} slots, the traffic has "
                                 f"{self.t['workers']} workers")
            rows = self.outer_step(global_step, h)
            return {"tokens": rows[..., :-1].contiguous(),
                    "targets": rows[..., 1:].contiguous(),
                    "mask": torch.ones(rows[..., 1:].shape,
                                       dtype=torch.float32,
                                       device=self.device)}
        return batches
