"""Beyond-paper gradient compression (port of ``repro.core.compression``).

  * **int4 packed quantization** (8x on the wire): the int8 scheme's
    6-sigma uniform range with 16 buckets, two codes packed per uint8
    byte.
  * **Error feedback (EF14-style)**: the residual ``pg - deq(q(pg))`` is
    kept locally and added to the next outer step's pseudo-gradient, so
    quantization bias cannot accumulate over outer steps.

The JAX package writes these in plain ``jnp`` (no Pallas kernel), so
they stay plain PyTorch on either device. Row-wise like
``kernels/ref.py``: ``(rows, n)`` in, one codebook per row out (the JAX
package ``vmap``s its flat functions over rows). sigma is the population
std (``jnp.std``), hence ``correction=0``, one reduction call per row
(``ref.row_std_mean``). Bucket sums add in fp64 and
round to fp32 once, counts are integers; the reference adds fp32 terms
one after another and counts in fp32, so codebooks agree to rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import row_std_mean

NUM_BUCKETS4 = 16
CLIP_SIGMAS = 6.0
_EPS = 1e-12


class Quantized4(NamedTuple):
    packed: torch.Tensor     # uint8 (rows, ceil(n / 2)), two codes a byte
    codebook: torch.Tensor   # fp32 (rows, 16)

    @property
    def wire_bytes(self) -> int:
        return int(self.packed.numel()) + 4 * NUM_BUCKETS4 * \
            self.codebook.shape[0]


def quantize4(x: torch.Tensor) -> Quantized4:
    """int4 quantization of each row of ``x`` (rows, n)."""
    xf = x.float()
    sigma, mu = row_std_mean(xf)
    half = CLIP_SIGMAS * sigma[:, None]
    mu = mu[:, None]
    lo = mu - half
    width = torch.clamp_min(2 * half / NUM_BUCKETS4, _EPS)
    codes = torch.clamp(torch.floor((xf - lo) / width), 0,
                        NUM_BUCKETS4 - 1).to(torch.uint8)
    rows = xf.shape[0]
    sums = torch.empty((rows, NUM_BUCKETS4), dtype=torch.float64,
                       device=x.device)
    counts = torch.empty((rows, NUM_BUCKETS4), dtype=torch.int64,
                         device=x.device)
    # 16 masked reductions a row: deterministic, and a row's bits do
    # not depend on how many rows share the call
    for r in range(rows):
        for b in range(NUM_BUCKETS4):
            hit = codes[r:r + 1] == b
            counts[r, b] = hit.sum()
            sums[r, b] = torch.where(hit, xf[r:r + 1], 0.0).sum(
                dim=-1, dtype=torch.float64)[0]
    centers = lo + (torch.arange(NUM_BUCKETS4, dtype=torch.float32,
                                 device=x.device) + 0.5) * width
    means = (sums / counts.clamp_min(1)).float()
    book = torch.where(counts > 0, means, centers)
    pair = F.pad(codes, (0, codes.shape[-1] % 2)).view(rows, -1, 2)
    packed = pair[..., 0] * 16 + pair[..., 1]
    return Quantized4(packed, book)


def dequantize4(q: Quantized4, n: int,
                dtype=torch.float32) -> torch.Tensor:
    """(rows, n) values of ``q``'s codes."""
    codes = torch.stack([q.packed // 16, q.packed % 16], dim=-1)
    codes = codes.view(q.packed.shape[0], -1)[:, :n]
    return torch.gather(q.codebook, 1, codes.long()).to(dtype)


def ef_compress(pg_flat: torch.Tensor, residual: torch.Tensor,
                quantize_fn, dequantize_fn):
    """Error-feedback wrapper: compress (pg + residual), return the wire
    payload and the new residual."""
    corrected = pg_flat + residual
    q = quantize_fn(corrected)
    deq = dequantize_fn(q)
    return q, corrected - deq


def init_residual(pg_flat_shape, device="cuda") -> torch.Tensor:
    return torch.zeros(pg_flat_shape, dtype=torch.float32, device=device)
