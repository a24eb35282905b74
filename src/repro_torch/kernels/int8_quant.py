"""The int8 codec kernels of the outer sync, hand-written in CUDA for
Hopper (``csrc/int8_quant.cu``), and their wrappers.

Replaces the Pallas TPU kernels of ``repro/kernels/int8_quant.py``:

  * ``encode_hist``            — codes + per-bucket (sum, count) in one
                                 read of x;
  * ``pseudograd_encode_hist`` — the same over ``scale * (anchor -
                                 theta)``, the pseudo-gradient never
                                 stored (the ring's first hop);
  * ``decode``                 — fp32 ``codebook[codes]``;
  * ``decode_add``             — ``acc + codebook[codes]`` in one pass,
                                 written into ``acc``.

Each takes all rows of a ``(rows, n)`` tensor in one call, with per-row
``lo``, ``width``, ``scale`` and codebooks held on the device (no host
sync). Bytes set the least time of all four; the deterministic
histogram costs instructions, which keep the encode at about 5x its
byte bound on an H100 (``PERF.md``). The source's header says what the
design does and why the histogram is deterministic.

A CUDA tensor launches the kernel (counted in ``<wrapper>.launches``) or
raises; a CPU tensor runs the plain version (``*_torch`` below, built
from ``kernels/ref.py``), which is also each kernel's oracle in the
tests and in ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

NUM_BUCKETS = ref.NUM_BUCKETS
_MAX_ROWS = 65535             # grid.y
_MAX_N = 2**31 - 1            # int32 counts


# -- plain versions -----------------------------------------------------------


def encode_hist_torch(x, lo, width):
    """(rows, n) fp32 -> codes uint8 (rows, n), sums fp32 (rows, 256),
    counts int32 (rows, 256)."""
    codes = ref.encode(x, lo, width)
    sums, counts = ref.bucket_stats(x, codes)
    return codes, sums, counts


def pseudograd_encode_hist_torch(anchor, theta, lo, width, *, scale=None):
    return encode_hist_torch(ref.pseudograd(anchor, theta, scale), lo, width)


def decode_torch(codes, codebook):
    return torch.gather(codebook, 1, codes.long())


def decode_add_torch(codes, codebook, acc):
    """``acc + codebook[codes]``, written into ``acc`` as the kernel
    does."""
    return acc.add_(decode_torch(codes, codebook))


# -- kernels ------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library (built at first use), with C signatures."""
    lib = _build.load("int8_quant")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.int8_encode_tile.restype = ll
    lib.int8_encode_hist_launch.argtypes = [p] * 10 + [ll, i, i, i, p]
    lib.int8_encode_hist_launch.restype = i
    lib.int8_decode_launch.argtypes = [p] * 4 + [ll, i, i, i, p]
    lib.int8_decode_launch.restype = i
    return lib


def _check_rows(name, t, dtype, dev, shape=None):
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, want {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")


def _check_2d(name, x):
    if x.dim() != 2:
        raise ValueError(f"{name}: want (rows, n), got {tuple(x.shape)}")
    rows, n = x.shape
    if not 1 <= rows <= _MAX_ROWS or not 1 <= n <= _MAX_N:
        raise ValueError(f"{name}: shape {tuple(x.shape)} outside "
                         f"1..{_MAX_ROWS} rows x 1..{_MAX_N} elements")


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _encode_launch(x, anchor, lo, width, scale):
    dev = x.device
    rows, n = x.shape
    lib = _lib()
    nblocks = -(-n // lib.int8_encode_tile())
    codes = torch.empty((rows, n), dtype=torch.uint8, device=dev)
    part_sum = torch.empty((rows, nblocks, NUM_BUCKETS), dtype=torch.float32,
                           device=dev)
    part_cnt = torch.empty((rows, nblocks, NUM_BUCKETS), dtype=torch.int32,
                           device=dev)
    sums = torch.empty((rows, NUM_BUCKETS), dtype=torch.float32, device=dev)
    counts = torch.empty((rows, NUM_BUCKETS), dtype=torch.int32, device=dev)
    fused = anchor is not None
    vec = n % 4 == 0 and _aligned(x, codes, *((anchor,) if fused else ()))
    err = lib.int8_encode_hist_launch(
        x.data_ptr(), anchor.data_ptr() if fused else None, lo.data_ptr(),
        width.data_ptr(), scale.data_ptr() if fused else None,
        codes.data_ptr(), part_sum.data_ptr(), part_cnt.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), n, rows, int(fused), int(vec),
        _stream(dev))
    if err:
        raise RuntimeError(f"int8 encode kernel launch failed with CUDA "
                           f"error {err}")
    return codes, sums, counts


def _check_encode(name, x, lo, width):
    _check_2d(name, x)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    rows = x.shape[0]
    _check_rows(f"{name}: x", x, torch.float32, x.device)
    _check_rows(f"{name}: lo", lo, torch.float32, x.device, (rows,))
    _check_rows(f"{name}: width", width, torch.float32, x.device, (rows,))


def encode_hist(x: torch.Tensor, lo: torch.Tensor, width: torch.Tensor):
    """x (rows, n) fp32, lo/width (rows,) fp32 -> codes uint8 (rows, n),
    per-row sums fp32 (rows, 256) and counts int32 (rows, 256)."""
    if x.device.type == "cpu":
        return encode_hist_torch(x, lo, width)
    _check_encode("encode_hist", x, lo, width)
    out = _encode_launch(x, None, lo, width, None)
    encode_hist.launches += 1
    return out


def pseudograd_encode_hist(anchor: torch.Tensor, theta: torch.Tensor,
                           lo: torch.Tensor, width: torch.Tensor, *,
                           scale: torch.Tensor | None = None):
    """``encode_hist`` of ``scale * (anchor - theta)`` (per-row ``scale``,
    None = 1) in one read of (anchor, theta)."""
    if theta.device.type == "cpu":
        return pseudograd_encode_hist_torch(anchor, theta, lo, width,
                                            scale=scale)
    _check_encode("pseudograd_encode_hist", theta, lo, width)
    _check_rows("pseudograd_encode_hist: anchor", anchor, torch.float32,
                theta.device, theta.shape)
    if scale is None:
        scale = torch.ones_like(lo)
    _check_rows("pseudograd_encode_hist: scale", scale, torch.float32,
                theta.device, lo.shape)
    out = _encode_launch(theta, anchor, lo, width, scale)
    pseudograd_encode_hist.launches += 1
    return out


def _decode_launch(name, codes, codebook, acc):
    _check_2d(name, codes)
    if codes.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {codes.device}")
    dev = codes.device
    rows, n = codes.shape
    _check_rows(f"{name}: codes", codes, torch.uint8, dev)
    _check_rows(f"{name}: codebook", codebook, torch.float32, dev,
                (rows, NUM_BUCKETS))
    if acc is None:
        out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    else:
        _check_rows(f"{name}: acc", acc, torch.float32, dev, (rows, n))
        out = acc
    vec = n % 16 == 0 and _aligned(codes, out)
    err = _lib().int8_decode_launch(
        codes.data_ptr(), codebook.data_ptr(),
        None if acc is None else acc.data_ptr(), out.data_ptr(), n, rows,
        int(acc is not None), int(vec), _stream(dev))
    if err:
        raise RuntimeError(f"int8 decode kernel launch failed with CUDA "
                           f"error {err}")
    return out


def decode(codes: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """codes uint8 (rows, n), codebook fp32 (rows, 256) -> fp32 (rows, n)."""
    if codes.device.type == "cpu":
        return decode_torch(codes, codebook)
    out = _decode_launch("decode", codes, codebook, None)
    decode.launches += 1
    return out


def decode_add(codes: torch.Tensor, codebook: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
    """``acc + codebook[codes]``, written into ``acc`` (fp32 (rows, n)),
    which is returned."""
    if codes.device.type == "cpu":
        return decode_add_torch(codes, codebook, acc)
    out = _decode_launch("decode_add", codes, codebook, acc)
    decode_add.launches += 1
    return out


encode_hist.launches = 0
pseudograd_encode_hist.launches = 0
decode.launches = 0
decode_add.launches = 0
