"""Learning-rate schedules (port of ``repro.optim.schedules``): WSD —
Warmup / Stable / Decay (Hägele et al., 2024) — and constant. A schedule
maps a step to a 0-d fp32 tensor, computed in fp32 as the reference
does."""
from __future__ import annotations

import math

import torch


def wsd(peak_lr: float, warmup_steps: int, total_steps: int,
        decay_fraction: float = 0.2, final_ratio: float = 0.0,
        decay_shape: str = "one_minus_sqrt"):
    """Warmup-Stable-Decay schedule: step -> lr."""
    decay_steps = max(1, int(total_steps * decay_fraction))
    decay_start = total_steps - decay_steps

    def schedule(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * torch.clamp(step / max(1, warmup_steps), max=1.0)
        frac = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
        if decay_shape == "linear":
            mult = 1.0 - (1.0 - final_ratio) * frac
        elif decay_shape == "cosine":
            mult = final_ratio + (1 - final_ratio) * 0.5 * (
                1 + torch.cos(math.pi * frac))
        else:  # "one_minus_sqrt" (Hägele et al. recommended)
            mult = 1.0 - (1.0 - final_ratio) * torch.sqrt(frac)
        return warm * torch.where(step >= decay_start, mult,
                                  torch.ones_like(mult))

    return schedule


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32)
