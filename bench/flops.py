"""The yardstick's counts: a model's FLOPs per trained token and the
bytes the int8 codec of one outer sync must move. Both follow from the
configuration and the traffic alone, whatever implements them.

FLOPs: 6 x the active weights a token multiplies through (attention,
the dense or routed and shared experts' feed-forward, the router, the
output head; not the input embedding, a lookup, nor the norms' gains)
plus the attention scores and their weighted sum, PaLM's 12 L s d_attn
halved for the causal mask: 6 L s d_attn, s the sequence length and
d_attn the heads' total width.

Codec bytes: each kernel call's inputs read once and outputs written
once, over the ring's geometry for k workers (chunks of ceil(n / k)
elements, k rows a call, ``repro_torch.core.ring_reduce.hop_codec_calls``'
calls): the fused first-hop encode reads the fp32 anchor and the
parameters in their stored dtype and writes codes and a histogram; an
encode reads fp32 and writes codes and a histogram; a decode reads
codes and a codebook and writes fp32; a decode-add reads codes, a
codebook and the fp32 sum and writes the sum.
"""
from __future__ import annotations

BUCKETS = 256


def active_params(c: dict) -> int:
    """Weights one token multiplies through, from a configuration file
    (its published vocabulary, not the padded one)."""
    d, hd = c["hidden_size"], c["assumed"]["head_dim"]
    h, hk, n = c["num_attention_heads"], c["num_key_value_heads"], \
        c["num_hidden_layers"]
    attn = d * hd * (2 * h + 2 * hk)
    dense_ffn = 3 * d * c["intermediate_size"]
    if c["family"] == "moe":
        f = c["moe_intermediate_size"]
        n_dense = c["first_k_dense_replace"]
        moe = (d * c["n_routed_experts"]
               + 3 * d * f * (c["num_experts_per_tok"]
                              + c["n_shared_experts"]))
        ffn = n_dense * dense_ffn + (n - n_dense) * moe
    else:
        ffn = n * dense_ffn
    return n * attn + ffn + d * c["vocab_size"]


def flops_per_token(c: dict, seq_len: int) -> float:
    d_attn = c["num_attention_heads"] * c["assumed"]["head_dim"]
    return 6.0 * active_params(c) + 6.0 * c["num_hidden_layers"] \
        * seq_len * d_attn


def codec_bytes_per_sync(n: int, k: int, theta_bytes: int) -> int:
    """Bytes the codec calls of one int8 ring all-reduce of n elements
    over k workers need (one sub-bucket a chunk)."""
    if k <= 1:
        return 0
    e = k * -(-n // k)                    # elements of one k-row call
    hist = k * BUCKETS * (4 + 4)          # sums and counts out
    book = k * BUCKETS * 4                # codebook in
    fused = e * (4 + theta_bytes) + k * 4 * 3 + e + hist   # lo, width, scale
    encode = e * 4 + k * 4 * 2 + e + hist                  # lo, width
    decode = e + book + e * 4
    decode_add = e + book + e * 4 + e * 4
    # reduce-scatter: k - 1 hops, the first through the fused encode;
    # all-gather: the owners' encode and decode, then k - 1 decodes
    return (fused + (k - 2) * encode + (k - 1) * decode_add
            + encode + decode + (k - 1) * decode)
