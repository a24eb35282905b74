"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]  24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, SWA window 4096. The SWA window makes attention
sub-quadratic, so long_500k RUNS for this arch (rolling KV cache of
window size)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,
    source="arXiv:2401.16818; hf",
)
