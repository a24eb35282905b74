"""Flash-decode: grouped-query single-token attention against the
per-slot KV cache, as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_decode.py::
flash_decode``. The kernel (``csrc/flash_decode.cu``) is bound by the K
and V bytes of the live cells; it splits S across blocks so the card
fills at decode batch sizes, keeps scores and probabilities in shared
memory, accumulates in fp32 and combines the per-split partials in a
second pass (see the note at the top of the source).

``flash_decode`` launches the kernel for CUDA tensors and raises on
what it does not take; for CPU tensors it runs ``flash_decode_torch``,
the plain PyTorch version of the same function, which is also the
kernel's oracle in the tests and in ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import NEG_INF, decode_valid_mask

MAX_HEAD_DIM = 256
MAX_SMEM = 40 * 1024          # dynamic shared memory of the split kernel;
# its static arrays (about 4 KB) take part of the 48 KB a block may use


def flash_decode_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       length: torch.Tensor, *,
                       window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: q (B, 1, Hq, dh), k/v (B, S_max, Hk, dh),
    length (B,) -> (B, 1, Hq, dh) in q's dtype, computed in fp32. Query
    head h reads kv head h // G; an empty slot returns 0."""
    b, t, hq, dh = q.shape
    s_max, hk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, t, hk, hq // hk, dh)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * dh ** -0.5
    valid = decode_valid_mask(length, s_max, window)[:, None, None, None]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~valid, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return out.reshape(b, t, hq, dh).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library (built at first use), with its C signatures."""
    lib = _build.load("flash_decode")
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_cells.restype = ctypes.c_int
    return lib


def _check(q, k, v, length) -> None:
    dev = q.device
    for name, t in (("k", k), ("v", v), ("length", length)):
        if t.device != dev:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_decode: q dtype {q.dtype} (bf16 or fp32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: q/k/v dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype} differ")
    if length.dtype != torch.int32:
        raise TypeError(f"flash_decode: length dtype {length.dtype} (int32)")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode: q shape {tuple(q.shape)}, "
                         "want (B, 1, Hq, dh)")
    b, _, hq, dh = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b
            or k.shape[3] != dh):
        raise ValueError(f"flash_decode: k/v shapes {tuple(k.shape)}/"
                         f"{tuple(v.shape)} vs q {tuple(q.shape)}")
    if tuple(length.shape) != (b,):
        raise ValueError(f"flash_decode: length shape {tuple(length.shape)}")
    hk = k.shape[2]
    if hq % hk:
        raise ValueError(f"flash_decode: Hq={hq} not a multiple of Hk={hk}")
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: dh={dh} must be a multiple of 8 "
                         f"and at most {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v), ("length", length)):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} is not contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):    # 16-byte row loads
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} not 16-byte aligned")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, *,
                 window: int | None = None) -> torch.Tensor:
    """q: (B, 1, Hq, dh); k/v: (B, S_max, Hk, dh); length: (B,) int32
    per-slot lengths; ``window``: SWA ring width or None. Returns
    (B, 1, Hq, dh) in q's dtype. A CUDA tensor launches the kernel (and
    counts it in ``flash_decode.launches``); a CPU tensor runs
    ``flash_decode_torch``."""
    if q.device.type == "cpu":
        return flash_decode_torch(q, k, v, length, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    _check(q, k, v, length)
    b, _, hq, dh = q.shape
    s_max, hk = k.shape[1], k.shape[2]
    g = hq // hk
    lib = _lib()
    cells = lib.flash_decode_cells()
    if g * (dh + cells) * 4 > MAX_SMEM:
        raise ValueError(f"flash_decode: G={g}, dh={dh} needs more than "
                         f"{MAX_SMEM} bytes of shared memory")
    n_splits = -(-s_max // cells)
    part_acc = torch.empty((b, hk, n_splits, g, dh), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hk, n_splits, g, 2), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        b, s_max, hk, g, dh, -1 if window is None else int(window),
        float(dh ** -0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode: kernel launch failed with CUDA "
                           f"error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
