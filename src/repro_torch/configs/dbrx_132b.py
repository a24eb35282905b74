"""dbrx-132b — large MoE: 16 experts top-4.
[hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (GQA kv=8) expert d_ff=10752 vocab=100352.

Memory plan: DiLoCo over the 'pod' axis ONLY (a full 132B replica per
DiLoCo worker needs ~16 bytes/param incl. Adam + anchor; 256 chips/pod
gives ~8.3 GB/chip) and params additionally FSDP-sharded over 'data'.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4, d_expert=10752),
    diloco_pref="pod_only",
    fsdp_data=True,
    source="hf:databricks/dbrx-base; unverified",
)
