"""INTELLECT-1 — the paper's own 10B model (Table 5): Llama-3
architecture, 42 layers (vs Llama3-8B's 32), d_model=4096, 32 heads,
GQA kv=8, d_ff=14336, vocab=128256, seq 8192, batch 128, max-z-loss
2e-4. Trained with DiLoCo H=100, inner AdamW lr 7.5e-5, outer Nesterov
lr 0.7 / momentum 0.9."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="intellect-1",
    family="dense",
    n_layers=42,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=5e5,
    source="INTELLECT-1 Technical Report, Appendix A",
)
