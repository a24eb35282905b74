"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]
54L d_model=2560 32H (kv=32) d_ff=10240, ssm_state=64.
One shared attention+MLP block applied every 6 layers (9 applications)
— simplified from Zamba2's shared-block-with-LoRA (DESIGN.md
§Arch-applicability). Hybrid -> long_500k RUNS."""
from repro_torch.configs.base import ArchConfig, SSMArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMArchConfig(d_state=64, head_dim=64),
    attn_every=6,
    source="arXiv:2411.15242; hf",
)
