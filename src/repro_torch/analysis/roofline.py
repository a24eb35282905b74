"""Roofline of a traced step on the H100 (port of
``repro.analysis.roofline``, whose constants are a TPU's).

Three terms, all in seconds per step and per rank:

    compute    = FLOPs / PEAK_FLOPS
    memory     = HBM bytes / HBM_BW
    collective = wire bytes / LINK_BW

The counts come from ``analysis.op_cost`` (a dispatch-mode trace of one
rank's step; HBM bytes there are an unfused upper bound). The wire
bytes use the reference's ring byte model per collective (see
``op_cost``).

Constants: the NVIDIA H100 SXM datasheet's dense bf16 tensor-core peak
(989 TFLOP/s) and HBM3 rate (3.35 TB/s), and NVLink 4's 450 GB/s one
way per card. The link term idealizes a 256-card mesh as if every card
had a full NVLink port to its ring neighbours; across nodes the rate is
the network's, several times lower.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12       # bf16 dense, H100 SXM datasheet
HBM_BW = 3.35e12          # bytes/s, H100 SXM HBM3
LINK_BW = 450e9           # bytes/s one way, NVLink 4 per card


@dataclasses.dataclass
class Roofline:
    flops: float              # per rank
    hbm_bytes: float          # per rank (unfused upper bound)
    wire_bytes: float         # per rank
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float        # 6*N*D (or 2*N*D serve), GLOBAL
    useful_ratio: float       # model_flops / (flops * n_chips)
    step_s: float
    mfu: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(cost, *, n_chips: int, model_flops: float) -> Roofline:
    """The roofline of one rank's ``op_cost.OpCost``; ``mfu`` is the
    bound the slowest term allows."""
    c = cost.flops / PEAK_FLOPS
    m = cost.hbm_bytes / HBM_BW
    x = cost.wire_bytes / LINK_BW
    terms = {"compute": c, "memory": m, "collective": x}
    bottleneck = max(terms, key=terms.get)
    step = max(c, m, x)
    useful = model_flops / max(cost.flops * n_chips, 1.0)
    mfu = (model_flops / n_chips / max(step, 1e-30)) / PEAK_FLOPS
    return Roofline(cost.flops, cost.hbm_bytes, cost.wire_bytes, c, m, x,
                    bottleneck, model_flops, useful, step, mfu)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active*tokens for training, 2*N_active*tokens
    for inference forward (decode counts one new token per sequence)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch      # decode: 1 token/seq
