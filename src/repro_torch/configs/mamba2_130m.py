"""mamba2-130m — pure SSM (SSD, state-space duality), attention-free.
[arXiv:2405.21060; unverified]
24L d_model=768 (attn-free, d_ff=0) vocab=50280, ssm_state=128,
tied embeddings. long_500k RUNS (O(1)-per-token recurrent decode)."""
from repro_torch.configs.base import ArchConfig, SSMArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,            # d_inner / head_dim = 1536 / 64
    n_kv_heads=24,
    d_ff=0,
    vocab=50280,
    ssm=SSMArchConfig(d_state=128, head_dim=64),
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
