"""ParallelismPlan (port of ``repro.sharding.plans``): which mesh axis
carries which form of parallelism for a given (arch x shape x mesh)
cell. The rules are the reference's, so every plan equals its plan.

The paper's hybrid (§2.3): DiLoCo across the slow fabric, FSDP inside:
  * ``diloco_axis``  — 'pod' (multi-pod: the inter-pod fabric is the
    "WAN") or 'data' (single-pod: 16 DiLoCo workers of 16-rank FSDP
    groups, the paper's many-small-nodes regime), or None (huge models
    single-pod, or serving);
  * params shard over 'model' (the rules in ``partition.py``) and
    optionally also over 'data' (``fsdp_data``, for dbrx-class models);
  * activations/batch shard over the non-DiLoCo data axes;
  * decode caches shard KV-heads over 'model' when divisible, else the
    sequence dim (SP) for long contexts.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class ParallelismPlan:
    diloco_axis: str | None
    rules: tuple[tuple[str, str | None], ...]  # logical -> mesh axis
    batch_axes: tuple[str, ...]                # activation batch sharding
    seq_axis: str | None                       # SP for long-context caches
    remat: bool
    n_workers: int                             # DiLoCo world size
    act_seq_axis: str | None = None            # SP for train activations
    microbatches: int = 1                      # gradient accumulation

    def rules_dict(self) -> dict:
        return dict(self.rules)


def make_plan(cfg: ArchConfig, shape: ShapeConfig,
              mesh_axes: dict[str, int]) -> ParallelismPlan:
    multi_pod = "pod" in mesh_axes
    diloco = None
    if shape.kind == "train":
        if cfg.diloco_pref == "none":
            diloco = None
        elif cfg.diloco_pref == "pod_only":
            diloco = "pod" if multi_pod else None
        else:  # auto: prefer the slow axis; else many workers in-pod
            diloco = "pod" if multi_pod else "data"

    fsdp_data = cfg.fsdp_data and diloco != "data"
    # tiny models: replicate params inside the DiLoCo worker and go pure
    # data-parallel over the 'model' axis too (TP shards would be
    # slivers and the SSD head count may not divide the axis)
    inner_dp = shape.kind == "train" and cfg.param_count() < 6e8
    if inner_dp:
        rules = (("vocab", None), ("heads", None), ("ff", None),
                 ("experts", None), ("embed", None), ("layers", None))
    elif fsdp_data and diloco is not None:
        # FSDP over data x model inside a DiLoCo worker: the reference
        # shards ONE dim over the combined ('data','model') axes
        # (256-way; its partitioner fails on two independently sharded
        # dims there). Same per-rank memory; kept so plans compare.
        combo = ("data", "model")
        rules = (("vocab", combo), ("heads", combo),
                 ("ff", [combo, "data"]),       # expert FFN: 'model'
                 ("experts", "model"),          # is taken by E -> use
                 ("embed", None),               # 'data' for d_expert
                 ("layers", None))
    else:
        rules = (
            ("vocab", "model"),
            ("heads", "model"),
            ("ff", "model"),
            ("experts", "model"),
            ("embed", "data" if fsdp_data else None),
            ("layers", None),
        )
    batch_axes = tuple(a for a in ("pod", "data")
                       if a in mesh_axes and a != diloco)
    if shape.kind == "train":
        # FSDP-style activation sharding: also spread the per-worker
        # batch over 'model' when it divides (params stay 'model'-
        # sharded storage, gathered per layer = FSDP)
        n_workers_est = mesh_axes.get(diloco, 1) if diloco else 1
        per_worker_batch = shape.global_batch // n_workers_est
        prod = 1
        for a in batch_axes + ("model",):
            prod *= mesh_axes[a]
        if per_worker_batch % prod == 0:
            batch_axes = batch_axes + ("model",)
    # SP: shard long decode caches over 'model' on the seq dim when the
    # batch is too small to cover the mesh and kv-heads don't divide
    # decode caches: sequence-parallel fallback over 'model' (used by
    # cache_pspec only when the KV-head count doesn't divide the axis)
    seq_axis = "model" if shape.kind in ("decode", "prefill") else None
    # training activations: when the batch can't cover data x model,
    # shard the SEQUENCE dim over 'model' (SP) for attention-family
    # archs — divides score tiles and their FLOPs by 16. (SSM/hybrid
    # scan over chunks sequentially; SP would serialize cross-device,
    # so those models ignore the hint.)
    act_seq_axis = None
    if (shape.kind == "train" and "model" not in batch_axes
            and not inner_dp and cfg.family not in ("ssm", "hybrid")
            and shape.seq_len % (mesh_axes["model"] * 32) == 0):
        act_seq_axis = "model"
    # activation checkpointing for every training shape (the paper's
    # FSDP training does the same; the SSD dual form in particular
    # saves O(L*Q) intra-chunk buffers without it)
    remat = shape.kind == "train"
    n_workers = mesh_axes.get(diloco, 1) if diloco else 1
    # gradient accumulation for the largest models: divides activation
    # peak by the microbatch count (params/optimizer unchanged)
    microbatches = 1
    if shape.kind == "train" and cfg.param_count() > 6e10:
        per_worker_batch = shape.global_batch // n_workers
        for cand in (4, 2):
            if per_worker_batch % cand == 0:
                microbatches = cand
                break
    return ParallelismPlan(diloco, rules, batch_axes, seq_axis, remat,
                           n_workers, act_seq_axis, microbatches)
