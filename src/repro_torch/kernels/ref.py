"""Plain PyTorch version of the PRIME int8 quantization scheme (port of
``repro.kernels.ref``), row-wise.

Paper (INTELLECT-1 §2.2): uniform quantization with clipping, after
Ryabinin et al. (2020):

  1. mean (mu) and population std (sigma) of the tensor,
  2. quantization range [mu - 6 sigma, mu + 6 sigma],
  3. the range divided uniformly into 256 buckets,
  4. codebook value per bucket = mean of the values that fall in it
     (an empty bucket falls back to its midpoint),
  5. reduction in fp32: only the wire format is int8.

Every function takes ``(rows, n)`` and treats each row as one tensor of
the JAX package: one ``lo``, ``width`` and codebook per row (the ring
quantizes one bucket per worker row in one call). These are the CPU path
of ``kernels/ops.py`` and the oracles of the CUDA kernels in
``kernels/int8_quant.py``.

Counts are integers (int32). ``repro.kernels.ref`` counts in fp32,
which stops growing at 2^24 per bucket; below that the two agree.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NUM_BUCKETS = 256
CLIP_SIGMAS = 6.0
_EPS = 1e-12


class Quantized(NamedTuple):
    """Wire format of ``rows`` quantized tensors (or tensor chunks)."""

    codes: torch.Tensor      # uint8 (rows, n)
    codebook: torch.Tensor   # fp32 (rows, 256) dequantization tables

    @property
    def wire_bytes(self) -> int:
        """Bytes on the wire: 1 byte per element plus one fp32 codebook
        sideband per row."""
        return int(self.codes.numel()) + 4 * NUM_BUCKETS * \
            self.codebook.shape[0]


def quant_params(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (lo, bucket_width) of the clipped uniform range, (rows,)
    fp32 each. sigma is the population std (``jnp.std``), hence
    ``correction=0``."""
    sigma, mu = torch.std_mean(x.float(), dim=-1, correction=0)
    half = CLIP_SIGMAS * sigma
    lo = mu - half
    width = torch.clamp_min(2.0 * half / NUM_BUCKETS, _EPS)
    return lo, width


def encode(x: torch.Tensor, lo: torch.Tensor,
           width: torch.Tensor) -> torch.Tensor:
    """Bucket indices (uint8) of every element: a true division by the
    width, as the reference does."""
    idx = torch.floor((x.float() - lo[:, None]) / width[:, None])
    return torch.clamp(idx, 0, NUM_BUCKETS - 1).to(torch.uint8)


def bucket_stats(x: torch.Tensor, codes: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row, per-bucket (sum fp32, count int32), (rows, 256) each.

    Sums accumulate in fp64 and round to fp32 once: this is the oracle
    of the kernel's sums. Adding millions of fp32 terms one after
    another, as the reference's scatter-add does, lets the rounding
    error grow with the count. One row at a time, so the fp64 and int64
    copies stay one row's size."""
    rows = x.shape[0]
    sums = torch.empty((rows, NUM_BUCKETS), dtype=torch.float32,
                       device=x.device)
    counts = torch.zeros((rows, NUM_BUCKETS), dtype=torch.int32,
                         device=x.device)
    for r in range(rows):
        c = codes[r].long()
        s64 = torch.zeros(NUM_BUCKETS, dtype=torch.float64, device=x.device)
        sums[r] = s64.index_add_(0, c, x[r].double()).float()
        counts[r].index_add_(0, c, torch.ones_like(c, dtype=torch.int32))
    return sums, counts


def make_codebook(sums: torch.Tensor, counts: torch.Tensor,
                  lo: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Bucket means; an empty bucket falls back to its midpoint."""
    ar = torch.arange(NUM_BUCKETS, dtype=torch.float32, device=sums.device)
    centers = lo[:, None] + (ar + 0.5) * width[:, None]
    means = sums / counts.clamp_min(1).float()
    return torch.where(counts > 0, means, centers)


def quantize(x: torch.Tensor) -> Quantized:
    """Full quantization of each row: codes + bucket-mean codebook."""
    lo, width = quant_params(x)
    codes = encode(x, lo, width)
    sums, counts = bucket_stats(x, codes)
    return Quantized(codes, make_codebook(sums, counts, lo, width))


def dequantize(q: Quantized, dtype=torch.float32) -> torch.Tensor:
    return torch.gather(q.codebook, 1, q.codes.long()).to(dtype)


def pseudograd(anchor: torch.Tensor, theta: torch.Tensor,
               scale: torch.Tensor | None = None) -> torch.Tensor:
    """``scale * (anchor - theta)`` in fp32, ``scale`` one value per row
    (None = unscaled)."""
    pg = anchor.float() - theta.float()
    if scale is not None:
        pg = pg * scale.float()[:, None]
    return pg


def quantize_pseudograd(anchor: torch.Tensor, theta: torch.Tensor,
                        scale: torch.Tensor | None = None) -> Quantized:
    """Pseudo-gradient ``scale * (anchor - theta)`` + quantize: the
    oracle of the fused encode kernel."""
    return quantize(pseudograd(anchor, theta, scale))
