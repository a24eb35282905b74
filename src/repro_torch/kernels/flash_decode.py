"""Flash-decode: grouped-query single-token attention against the
per-slot KV cache, dense or paged, as a hand-written CUDA kernel for
Hopper.

Replaces the Pallas TPU kernels ``repro/kernels/flash_decode.py::
flash_decode`` and ``::flash_decode_paged``. The kernel
(``csrc/flash_decode.cu``) is bound by the K and V bytes of the live
cells; it splits S across blocks so the card fills at decode batch
sizes, keeps scores and probabilities in shared memory, accumulates in
fp32 and combines the per-split partials in a second pass (see the note
at the top of the source). The paged variant is the same split kernel
with each cell's row looked up through the block table, so it is
bitwise equal to the dense kernel on the gathered view.

``flash_decode`` and ``flash_decode_paged`` launch the kernel for CUDA
tensors and raise on what it does not take; for CPU tensors they run
``flash_decode_torch`` and ``flash_decode_paged_torch``, the plain
PyTorch versions of the same functions, which are also the kernel's
oracle in the tests and in ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import (NEG_INF, PagedKVCache,
                                          decode_valid_mask, paged_view)

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


def flash_decode_paged_torch(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, table: torch.Tensor,
                             length: torch.Tensor, *,
                             window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the paged kernel: the pool
    (N_blocks, blk, Hk, dh) gathered through ``table`` (B, nb), -1
    entries clamped to trash block 0, into the dense (B, nb * blk, Hk,
    dh) view, then ``flash_decode_torch``."""
    view = paged_view(PagedKVCache(k_pool, v_pool, table, length))
    return flash_decode_torch(q, view.k, view.v, length, window=window)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library (built at first use), with its C signatures."""
    lib = _build.load("flash_decode")
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_paged_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_paged_launch.restype = ctypes.c_int
    lib.flash_decode_cells.restype = ctypes.c_int
    return lib


def _check(q, k, v, length, fn: str = "flash_decode") -> None:
    """What both kernels take of q, the K/V rows (cache or pool: 4-dim,
    last two dims (Hk, dh)) and the lengths; the batch of k is checked
    by the caller."""
    dev = q.device
    for name, t in (("k", k), ("v", v), ("length", length)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{fn}: q dtype {q.dtype} (bf16 or fp32)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{fn}: q/k/v dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype} differ")
    if length.dtype != torch.int32:
        raise TypeError(f"{fn}: length dtype {length.dtype} (int32)")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{fn}: q shape {tuple(q.shape)}, "
                         "want (B, 1, Hq, dh)")
    b, _, hq, dh = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[3] != dh:
        raise ValueError(f"{fn}: k/v shapes {tuple(k.shape)}/"
                         f"{tuple(v.shape)} vs q {tuple(q.shape)}")
    if tuple(length.shape) != (b,):
        raise ValueError(f"{fn}: length shape {tuple(length.shape)}")
    hk = k.shape[2]
    if hq % hk:
        raise ValueError(f"{fn}: Hq={hq} not a multiple of Hk={hk}")
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"{fn}: dh={dh} must be a multiple of 8 "
                         f"and at most {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v), ("length", length)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):    # 16-byte row loads
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} not 16-byte aligned")


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
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"flash_decode: k/v shape {tuple(k.shape)} vs q "
                         f"{tuple(q.shape)}")
    lib = _lib()
    out, part_acc, part_ml = _outputs(q, k.shape[1], k.shape[2], lib)
    b, _, hq, dh = q.shape
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        b, k.shape[1], k.shape[2], hq // k.shape[2], dh,
        -1 if window is None else int(window), float(dh ** -0.5),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode: kernel launch failed with CUDA "
                           f"error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def _outputs(q, s_max: int, hk: int, lib):
    """The output and the fp32 split partials of one launch over s_max
    cells; raises if the split kernel's shared memory would not fit."""
    b, _, hq, dh = q.shape
    g = hq // hk
    cells = lib.flash_decode_cells()
    if g * (dh + cells) * 4 > MAX_SMEM:
        raise ValueError(f"flash_decode: G={g}, dh={dh} needs more than "
                         f"{MAX_SMEM} bytes of shared memory")
    n_splits = -(-s_max // cells)
    part_acc = torch.empty((b, hk, n_splits, g, dh), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hk, n_splits, g, 2), dtype=torch.float32,
                          device=q.device)
    return torch.empty_like(q), part_acc, part_ml


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, table: torch.Tensor,
                       length: torch.Tensor, *,
                       window: int | None = None) -> torch.Tensor:
    """q: (B, 1, Hq, dh); k_pool/v_pool: (N_blocks, blk, Hk, dh), the
    physical block pool; table: (B, nb) int32 pool block of each
    virtual block, -1 = unmapped (reads trash block 0); length: (B,)
    int32; ``window``: SWA ring width (the ring is the nb * blk virtual
    cells) or None. Returns (B, 1, Hq, dh) in q's dtype. A CUDA tensor
    launches the kernel (and counts it in
    ``flash_decode_paged.launches``); a CPU tensor runs
    ``flash_decode_paged_torch``. Table entries are not checked against
    the pool on the host (that would cost a device sync per call): the
    kernel reads block 0 for any entry outside [1, N_blocks)."""
    if q.device.type == "cpu":
        return flash_decode_paged_torch(q, k_pool, v_pool, table, length,
                                        window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged: unsupported device "
                         f"{q.device}")
    _check(q, k_pool, v_pool, length, "flash_decode_paged")
    b = q.shape[0]
    if table.device != q.device:
        raise ValueError(f"flash_decode_paged: table on {table.device}, "
                         f"q on {q.device}")
    if table.dtype != torch.int32:
        raise TypeError(f"flash_decode_paged: table dtype {table.dtype} "
                        "(int32)")
    if table.dim() != 2 or table.shape[0] != b or table.shape[1] < 1:
        raise ValueError(f"flash_decode_paged: table shape "
                         f"{tuple(table.shape)}, want ({b}, nb)")
    if not table.is_contiguous():
        raise ValueError("flash_decode_paged: table is not contiguous")
    n_blocks, blk, hk, dh = k_pool.shape
    nb = table.shape[1]
    lib = _lib()
    out, part_acc, part_ml = _outputs(q, nb * blk, hk, lib)
    err = lib.flash_decode_paged_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), length.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), out.data_ptr(), b, nb, blk, n_blocks, hk,
        q.shape[2] // hk, dh, -1 if window is None else int(window),
        float(dh ** -0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode_paged: kernel launch failed with "
                           f"CUDA error {err}")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
