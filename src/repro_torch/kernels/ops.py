"""Public wrappers over the int8 codec (port of ``repro.kernels.ops``).

The tensor's device picks the route, as in ``kernels/flash_decode.py``:
a CUDA tensor launches the hand-written kernels of
``kernels/int8_quant.py`` (or raises), a CPU tensor runs their plain
versions. The JAX package's ``impl='jnp'|'pallas'`` switch has no
counterpart. The per-row stats pass (``ref.quant_params``: a mean and a
population std) stays plain PyTorch on either device, as XLA computes it
outside the Pallas kernel in the JAX package.

Everything is row-wise: ``(rows, n)`` in, one codebook per row out.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import int8_quant, ref

Quantized = ref.Quantized


def quantize(x: torch.Tensor) -> Quantized:
    """Paper-faithful int8 quantization of each row (6-sigma clip,
    bucket-mean codebook)."""
    x = x.float()
    lo, width = ref.quant_params(x)
    codes, sums, counts = int8_quant.encode_hist(x, lo, width)
    return Quantized(codes, ref.make_codebook(sums, counts, lo, width))


def quantize_pseudograd(anchor: torch.Tensor, theta: torch.Tensor, *,
                        scale: torch.Tensor | None = None) -> Quantized:
    """``quantize(scale * (anchor - theta))`` (``scale`` per row, None =
    unscaled) with the encode fused: the kernel reads (anchor, theta)
    and never stores the pseudo-gradient. The stats pass does build it
    once, for the mean and std."""
    anchor, theta = anchor.float(), theta.float()
    lo, width = ref.quant_params(ref.pseudograd(anchor, theta, scale))
    codes, sums, counts = int8_quant.pseudograd_encode_hist(
        anchor, theta, lo, width,
        scale=None if scale is None else scale.float())
    return Quantized(codes, ref.make_codebook(sums, counts, lo, width))


def dequantize(q: Quantized, *, dtype=torch.float32) -> torch.Tensor:
    return int8_quant.decode(q.codes, q.codebook).to(dtype)


def dequantize_add(q: Quantized, acc: torch.Tensor) -> torch.Tensor:
    """``acc + dequantize(q)``, fused, written into ``acc`` (fp32)."""
    return int8_quant.decode_add(q.codes, q.codebook, acc)
