"""seamless-m4t-medium — enc-dec multimodal (speech) backbone.
[arXiv:2308.11596; hf]  12L (6 enc + 6 dec here; the assignment's "12L"
is split evenly), d_model=1024, 16H (GQA kv=16 == MHA), d_ff=4096,
vocab=256206. The speech frontend is a stub: input_specs() provides
precomputed frame embeddings. Shapes: src_len = tgt_len = seq_len // 2
so total processed positions == seq_len (documented in DESIGN.md)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    source="arXiv:2308.11596; hf",
)
