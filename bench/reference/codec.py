"""The int8 wire codec of the outer sync and the ring mean it serves, in
plain PyTorch (INTELLECT-1 §2.2).

A vector is quantized on its own statistics: mean mu and population
standard deviation sigma, the range [mu - 6 sigma, mu + 6 sigma] cut
into 256 equal buckets, each element's code the bucket it falls in
(clamped), and the codebook each bucket's mean of the values that fell
in it (an empty bucket: its midpoint). Decoding looks the codes up.

The ring over k workers cuts each worker's vector, zero-padded to k
equal chunks, into those chunks. Chunk c starts at worker c and travels
k - 1 hops round the ring: at each hop the sender's running sum is
quantized and decoded, and the receiver adds its own value of the chunk
in fp32. The last worker quantizes the full sum once and every worker
decodes the same codes. The result is that sum over the total weight.
"""
from __future__ import annotations

import torch

BUCKETS = 256
CLIP = 6.0


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (n,) fp32 -> (codes int64 (n,), codebook fp32 (256,))."""
    x64 = x.double()
    sigma, mu = torch.std_mean(x64, correction=0)
    lo = mu - CLIP * sigma
    width = torch.clamp_min(2 * CLIP * sigma / BUCKETS, 1e-12)
    codes = torch.floor((x64 - lo) / width).clamp(0, BUCKETS - 1).long()
    sums = torch.bincount(codes, weights=x64, minlength=BUCKETS)
    counts = torch.bincount(codes, minlength=BUCKETS)
    mids = lo + (torch.arange(BUCKETS, dtype=torch.float64,
                              device=x.device) + 0.5) * width
    book = torch.where(counts > 0, sums / counts.clamp_min(1), mids)
    return codes, book.float()


def dequantize(codes: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    return book[codes]


def roundtrip(x: torch.Tensor) -> torch.Tensor:
    return dequantize(*quantize(x))


def ring_mean(rows: torch.Tensor, weights: torch.Tensor | None = None,
              exchange: bool = True) -> torch.Tensor:
    """The int8 ring's weighted mean of the k rows (k, n) fp32 -> (n,).

    ``exchange=False`` is a fault the benchmark's control test plants:
    no chunk leaves its worker, so worker 0's result is its own row,
    quantized once."""
    k, n = rows.shape
    if weights is None:
        weights = torch.ones(k, dtype=torch.float32, device=rows.device)
    chunk = -(-n // k)
    pad = torch.zeros((k, k * chunk - n), dtype=rows.dtype,
                      device=rows.device)
    x = torch.cat([rows, pad], dim=1) * weights[:, None]
    out = torch.empty(k * chunk, dtype=torch.float32, device=rows.device)
    for c in range(k):
        sl = slice(c * chunk, (c + 1) * chunk)
        if not exchange:
            out[sl] = roundtrip(x[0, sl])
            continue
        acc = x[c, sl]
        for j in range(1, k):
            acc = x[(c + j) % k, sl] + roundtrip(acc)
        out[sl] = roundtrip(acc)
    return out[:n] / (weights.sum() if exchange else weights[0])
