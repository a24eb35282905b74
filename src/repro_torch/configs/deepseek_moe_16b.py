"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6,
first layer dense. [arXiv:2401.06066; hf]
28L d_model=2048 16H (kv=16) d_ff(dense layer)=10944, expert d_ff=1408,
vocab=102400."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,            # the single dense layer's FFN
    vocab=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  first_dense=1),
    source="arXiv:2401.06066; hf",
)
