"""Architecture + shape configuration system.

Every assigned architecture gets one file in this package instantiating
``ArchConfig`` with the published numbers; ``reduced()`` derives the
small same-family sibling used by the CPU smoke tests. The four
input-shape cells are global (``SHAPES``); applicability rules (e.g.
long_500k requires a sub-quadratic path) live on the config.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    first_dense: int = 0          # leading dense-FFN layers (DeepSeek)
    capacity_factor: float = 1.25
    lb_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMArchConfig:
    d_state: int
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    expand: int = 2
    # SSD chunk: the intra-chunk L-matrix scales with b*L*q while the
    # stacked inter-chunk states scale with b*(L/q)*p*n -> q ~ sqrt(p*n)
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str        # 'dense' | 'moe' | 'vlm' | 'encdec' | 'ssm' | 'hybrid'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    moe: MoEConfig | None = None
    ssm: SSMArchConfig | None = None
    sliding_window: int | None = None
    attn_every: int | None = None     # hybrid: shared attn period
    n_frontend: int = 0               # VLM/audio stub tokens
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    max_z_weight: float = 2e-4        # paper: auxiliary max-z loss
    block_q: int = 512                # chunked-attention query block
    source: str = ""
    # per-arch parallelism hints (see sharding.plans)
    diloco_pref: str = "auto"         # 'auto' | 'pod_only' | 'none'
    fsdp_data: bool = False           # additionally shard params on 'data'
    # the JAX package's decode-attention switch, kept so configs compare
    # field for field; the port reads the tensor's device instead (CUDA
    # runs the hand-written kernel, the CPU its plain version)
    decode_attn_impl: str = "jnp"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.dtype]

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/head
        shard evenly over a 16-wide model axis (Megatron-style vocab
        padding — the published size stays the *logical* vocab)."""
        return -(-self.vocab // 256) * 256

    # -- applicability --------------------------------------------------------

    @property
    def sub_quadratic(self) -> bool:
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def supports(self, shape: ShapeConfig) -> bool:
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False          # dense-attn 500k has no sub-quadratic path
        return True

    # -- analytic parameter counts -------------------------------------------

    def param_count(self) -> int:
        d, hd = self.d_model, self.head_dim or self.d_model // self.n_heads
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe", "vlm"):
            att = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
            if self.moe:
                n_moe = self.n_layers - self.moe.first_dense
                moe_l = (d * self.moe.n_experts
                         + 3 * d * self.moe.d_expert * self.moe.n_experts
                         + 3 * d * self.moe.d_expert * self.moe.n_shared)
                dense_l = 3 * d * self.d_ff
                return (emb + self.n_layers * att
                        + n_moe * moe_l + self.moe.first_dense * dense_l)
            return emb + self.n_layers * (att + 3 * d * self.d_ff)
        if self.family == "encdec":
            att = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
            n_enc = self.n_layers // 2
            n_dec = self.n_layers - n_enc
            return (emb + n_enc * (att + 3 * d * self.d_ff)
                    + n_dec * (2 * att + 3 * d * self.d_ff))
        # ssm / hybrid
        s = self.ssm
        di = s.expand * d
        gn = s.n_groups * s.d_state
        h = di // s.head_dim
        mamba_l = (2 * d * di + 2 * d * gn + d * h     # projections
                   + s.conv_kernel * (di + 2 * gn)     # convs
                   + 3 * h + di + di * d)              # A/D/dt, norm, out
        total = emb + self.n_layers * mamba_l
        if self.attn_every:
            att = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
            total += att + 3 * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Active params per token (= total unless MoE)."""
        if not self.moe:
            return self.param_count()
        n_moe = self.n_layers - self.moe.first_dense
        routed = 3 * self.d_model * self.moe.d_expert * self.moe.n_experts
        active_routed = routed * self.moe.top_k / self.moe.n_experts
        return int(self.param_count() - n_moe * (routed - active_routed))

    # -- smoke-test sibling ----------------------------------------------------

    def reduced(self) -> "ArchConfig":
        kw = dict(
            name=self.name + "-reduced",
            n_layers=max(2, 4 if self.attn_every else 2),
            d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if
            self.n_kv_heads < self.n_heads else 4,
            d_ff=128, vocab=512, head_dim=16,
            dtype="float32", block_q=64,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=2, d_expert=32,
                n_shared=min(self.moe.n_shared, 1),
                first_dense=min(self.moe.first_dense, 1))
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=16)
            kw["d_ff"] = 128 if self.d_ff else 0
        if self.attn_every:
            kw["attn_every"] = 2
        if self.sliding_window:
            kw["sliding_window"] = 32
        if self.n_frontend:
            kw["n_frontend"] = 8
        return dataclasses.replace(self, **kw)
