"""minicpm-2b — dense llama-like, WSD schedule, tied embeddings.
[arXiv:2404.06395; hf]  40L d_model=2304 36H (kv=36, MHA) d_ff=5760
vocab=122753. MiniCPM popularized the WSD schedule the paper also uses
(optim/schedules.py)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
    source="arXiv:2404.06395; hf",
)
