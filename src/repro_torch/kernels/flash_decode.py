"""Flash-decode: grouped-query single-token attention against the
per-slot KV cache, dense or paged, as a hand-written CUDA kernel for
Hopper.

Replaces the Pallas TPU kernels ``repro/kernels/flash_decode.py::
flash_decode`` and ``::flash_decode_paged``. The kernel
(``csrc/flash_decode.cu``) is bound by the K and V bytes of the live
cells. The first design (two launches: a split kernel writing fp32
partials of every 32-cell split, live or not, and a combine kernel
reading them back) ran about 21x that bound at the serving shape, a
fixed chain of latencies. This one is one launch with no scratch: a
cluster of ``CLUSTER`` blocks per (kv head, slot) splits the slot's live
prefix into contiguous tile ranges (``cluster_ranges`` models how),
producer warps stream each live cell's K and V rows into a ring of 2 to
``STAGES`` shared-memory stages with 16-byte ``cp.async`` copies
completing on mbarriers, consumer warps keep an online softmax and the
fp32 output in registers, and the blocks combine their partials through
the cluster's distributed shared memory in rank order (see the note at
the top of the source). The paged variant is the same kernel with each
cell's row looked up through the block table, so it is bitwise equal to
the dense kernel on the gathered view, and a call repeats bit for bit.

``flash_decode`` and ``flash_decode_paged`` launch the kernel for CUDA
tensors and raise on what it does not take; for CPU tensors they run
``flash_decode_torch`` and ``flash_decode_paged_torch``, the plain
PyTorch versions of the same functions, which are also the kernel's
oracle in the tests and in ``chip_smoke.py``. ``flash_decode_partial``
is the block variant for a cache split by sequence over ranks (the
sharded serve step's seq layout): the dense kernel over one block that
also writes each query head's log-sum-exp, so ``merge_partials`` (plain
PyTorch, fp32, in rank order) combines the blocks into the attention
over the whole cache; ``flash_decode_partial_torch`` is its plain
version. ``trace_phases`` times one
launch block by block, from a build that stamps each phase.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import (NEG_INF, PagedKVCache,
                                          decode_valid_mask, paged_view)

MAX_HEAD_DIM = 256
MAX_SMEM = 232448             # dynamic shared memory a block may use
# the kernel's constants (``#define``s of csrc/flash_decode.cu)
TILE_CELLS = 32               # FD_TILE: cache cells per shared-memory stage
CLUSTER = 8                   # FD_CLUSTER: blocks per cluster
STAGES = 3                    # FD_STAGES: most stages of the K/V ring
KERNEL_NAME = "flash_decode_kernel"   # the device kernel, as profilers show it
TRACE_BLOCKS = 4096           # FD_TRACE_BLOCKS: blocks a traced build stamps
# what each of a block's stamps in a traced build marks (trace_phases)
PHASES = ("entry", "q_ready", "first_tile_issued", "first_tile_landed",
          "last_tile_done", "partials_ready", "output_written", "exit")


def cluster_ranges(length: int, s_max: int) -> list[tuple[int, int]]:
    """The cells [start, end) that each block of a cluster reads, in rank
    order: the live prefix [0, hi), hi = min(length, s_max) (an SWA ring
    that wrapped is live up to s_max), cut into tiles of ``TILE_CELLS``
    cells and split into ``CLUSTER`` contiguous runs of whole tiles, ends
    clipped to s_max. The kernel's ``tile_range``; cells of a range that
    are not live are masked, never read."""
    hi = max(0, min(int(length), s_max))
    n = -(-hi // TILE_CELLS)
    return [(r * n // CLUSTER * TILE_CELLS,
             min((r + 1) * n // CLUSTER * TILE_CELLS, s_max))
            for r in range(CLUSTER)]


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


def flash_decode_partial_torch(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, length: torch.Tensor):
    """Plain PyTorch version of the block variant: attention of q
    (B, 1, Hq, dh) over one block of a cache, k/v (B, S_blk, Hk, dh),
    whose cells [0, length) are live (no window). Returns (out, lse):
    out as ``flash_decode_torch`` gives it (0 for a slot with no live
    cell), lse (B, Hq) fp32 the log-sum-exp of the block's scaled
    scores (-inf for such a slot)."""
    b, t, hq, dh = q.shape
    s_max, hk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, t, hk, hq // hk, dh)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * dh ** -0.5
    valid = decode_valid_mask(length, s_max, None)[:, None, None, None]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskd->btkgd", p / l.clamp_min(1e-30),
                       v.float())
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))
    return (out.reshape(b, t, hq, dh).to(q.dtype),
            lse.reshape(b, hq).float())


def merge_partials(outs, lses) -> torch.Tensor:
    """Merge the block variant's partials of disjoint blocks of one cache
    into the attention over all of them: outs (B, 1, Hq, dh) and lses
    (B, Hq), one pair a block, weighted by exp(lse - max lse) and summed
    in fp32 in the given (rank) order. Returns the outs' dtype; a slot
    with no live cell in any block gives 0. Plain PyTorch: elementwise
    over (B, Hq, dh), no kernel."""
    lse = torch.stack([x.float() for x in lses])               # (n, B, Hq)
    top = lse.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    w = torch.exp(lse - top)                                   # -inf -> 0
    acc = None
    for o, wr in zip(outs, w):
        part = o.float() * wr[:, None, :, None]
        acc = part if acc is None else acc + part
    total = w.sum(dim=0)[:, None, :, None]
    return (acc / total.clamp_min(1e-30)).to(outs[0].dtype)


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
    return _signatures(_build.load("flash_decode"))


def _signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    lib.flash_decode_paged_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_paged_launch.restype = ctypes.c_int
    lib.flash_decode_partial_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.flash_decode_partial_launch.restype = ctypes.c_int
    lib.flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.flash_decode_smem_bytes.restype = ctypes.c_longlong
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
    out = _launch_dense(_lib(), q, k, v, length, window)
    flash_decode.launches += 1
    return out


def _launch_dense(lib, q, k, v, length, window) -> torch.Tensor:
    b, _, hq, dh = q.shape
    _check_smem(hq // k.shape[2], dh, q.dtype == torch.bfloat16, k.shape[1],
                1, False)
    out = torch.empty_like(q)
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), b, k.shape[1], k.shape[2], hq // k.shape[2], dh,
        -1 if window is None else int(window), float(dh ** -0.5),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode: kernel launch failed with CUDA "
                           f"error {err}")
    return out


flash_decode.launches = 0


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: torch.Tensor):
    """The block variant: q (B, 1, Hq, dh), k/v (B, S_blk, Hk, dh) one
    block of a cache split by sequence, length (B,) int32 its live cells
    (a prefix [0, length) of the block; no window). Returns (out, lse):
    out (B, 1, Hq, dh) in q's dtype, lse (B, Hq) fp32 (-inf and out 0
    for a slot with no live cell); ``merge_partials`` combines blocks. A
    CUDA tensor launches the kernel with its log-sum-exp output (counted
    in ``flash_decode_partial.launches``); a CPU tensor runs
    ``flash_decode_partial_torch``."""
    if q.device.type == "cpu":
        return flash_decode_partial_torch(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_partial: unsupported device "
                         f"{q.device}")
    _check(q, k, v, length, "flash_decode_partial")
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"flash_decode_partial: k/v shape "
                         f"{tuple(k.shape)} vs q {tuple(q.shape)}")
    b, _, hq, dh = q.shape
    s_blk, hk = k.shape[1], k.shape[2]
    _check_smem(hq // hk, dh, q.dtype == torch.bfloat16, s_blk, 1, False)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    err = _lib().flash_decode_partial_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, s_blk, hk, hq // hk, dh,
        float(dh ** -0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode_partial: kernel launch failed "
                           f"with CUDA error {err}")
    flash_decode_partial.launches += 1
    return out, lse


flash_decode_partial.launches = 0


@functools.cache
def _check_smem(g: int, dh: int, bf16: bool, s_max: int, blk: int,
                paged: bool) -> None:
    """Raise if a block of this launch needs more shared memory than a
    block may use (the K/V stages grow with dh, the paged table entries
    with S_max / blk). Cached: the decode loop asks the same each call."""
    smem = _lib().flash_decode_smem_bytes(g, dh, int(bf16), s_max, blk,
                                          int(paged))
    if smem > MAX_SMEM:
        raise ValueError(f"flash_decode: G={g}, dh={dh}, S_max={s_max}, "
                         f"blk={blk} needs {smem} bytes of shared memory, "
                         f"more than {MAX_SMEM}")


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
    g = q.shape[2] // hk
    _check_smem(g, dh, q.dtype == torch.bfloat16, nb * blk, blk, True)
    out = torch.empty_like(q)
    err = _lib().flash_decode_paged_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), length.data_ptr(), out.data_ptr(), b, nb, blk,
        n_blocks, hk, g, dh, -1 if window is None else int(window),
        float(dh ** -0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode_paged: kernel launch failed with "
                           f"CUDA error {err}")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


@functools.cache
def _trace_lib() -> ctypes.CDLL:
    """The kernel built with ``-DFD_TRACE=1`` (phase stamps), at first
    use, beside the plain build."""
    path = _build.library_path("flash_decode")
    path = path.with_name(path.stem + "-trace.so")
    if not path.exists():
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build.BUILD)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DFD_TRACE=1",
                 "-o", tmp, str(_build.CSRC / "flash_decode.cu")],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for the traced "
                                   f"flash_decode.cu:\n{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = _signatures(ctypes.CDLL(str(path)))
    lib.flash_decode_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.flash_decode_trace.restype = ctypes.c_int
    return lib


def trace_phases(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, *,
                 window: int | None = None) -> torch.Tensor:
    """Where one dense launch's time goes, block by block: a traced build
    of the kernel runs ``flash_decode``'s call twice untimed, then once
    with stamps. Returns (blocks, len(PHASES)) float64 on the CPU, in
    microseconds from the first block's entry, -1 where a block has no
    such stamp (no tile); rows in launch order (slot, kv head x head
    group, cluster rank). Not counted in ``flash_decode.launches``."""
    _check(q, k, v, length, "trace_phases")
    if q.device.type != "cuda":
        raise ValueError("trace_phases: needs CUDA tensors")
    lib = _trace_lib()
    for _ in range(2):
        _launch_dense(lib, q, k, v, length, window)
    torch.cuda.synchronize(q.device)
    err = lib.flash_decode_trace(None, 1)
    if not err:
        _launch_dense(lib, q, k, v, length, window)
        torch.cuda.synchronize(q.device)
        stamps = torch.zeros((TRACE_BLOCKS, len(PHASES)),
                             dtype=torch.int64)
        err = lib.flash_decode_trace(stamps.data_ptr(), 0)
    if err:
        raise RuntimeError(f"trace_phases: CUDA error {err}")
    stamps = stamps[:int((stamps[:, 0] > 0).sum())]
    rel = (stamps - stamps[:, 0].min()).double() / 1e3
    return torch.where(stamps > 0, rel, -1.0)
