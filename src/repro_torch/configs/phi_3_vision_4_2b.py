"""phi-3-vision-4.2b — phi3-mini backbone + CLIP vision frontend (STUB).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
32L d_model=3072 32H (kv=32, MHA) d_ff=8192 vocab=32064.
input_specs() provides 576 precomputed patch embeddings per image,
prepended to the text tokens; the loss is masked to text positions.
train_4k: 576 image + 3520 text positions = 4096 total."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    n_frontend=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)
