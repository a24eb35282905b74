"""The encode kernel's fixed-point histogram sums
(``repro_torch/kernels/csrc/int8_quant.cu``), modelled in plain PyTorch
on the CPU, against the fp64 oracle ``repro_torch.kernels.ref`` and the
JAX reference ``repro.kernels.ref``.

The CUDA kernel runs only on the card; its arithmetic is integer and
exact but for three roundings, which the model below repeats step by
step: each element's ``round(v * 2^shift)`` to int64, the conversion of
the row's integer total to fp64, and the final fp32. Between them it
keeps the kernel's words and asserts their ranges: a warp's 32-bit low
and high words over 8 elements a lane, its 64-bit sums, a block's sums
and the row's split global totals. Far outliers (``|v| >= lim``) go to
fp64 sums of buckets 0 and 255 as in the kernel. So a wrong exponent,
an overflow or a lost element shows here before any chip run.

Tolerances: sums within 1e-4 of the bucket's sum of |x| of the fp64
oracle (the check of ``tests/test_torch_int8_quant_cuda.py`` and
``chip_smoke.py``); codebooks against ``repro.kernels.ref.quantize``
within rtol 1e-5, atol 1e-6 bucket widths (the tolerance of
``tests/test_torch_int8_quant.py``); counts exact.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "int8_quant.cu")
# the kernel's constants (#defines of the source above)
THREADS, ITERS, UNROLL = 256, 64, 2
TILE = THREADS * 4 * ITERS   # ENC_TILE: elements per block
FIX_BITS = 46                # |q| < 2^FIX_BITS
FIX_EXP_MIN = -80
LO_BITS = 23                 # a term's unsigned low part


def row_fix(lo, width):
    """(shift, e) per row, as ``row_fix`` in the source: r < 2^e with
    r = max(|lo|, |lo + 256 width|) in fp32, e clamped to [-80, 128]."""
    r = torch.maximum(lo.abs(), (lo + 256.0 * width).abs())
    e = torch.frexp(r)[1].long()
    e = torch.where(torch.isfinite(r), e, 128).clamp_min(FIX_EXP_MIN)
    return FIX_BITS - 1 - e, e


def fixed_point_sums(x, codes, lo, width):
    """The kernel's bucket sums, in its arithmetic: fp32 (rows, 256)."""
    rows, n = x.shape
    shift, e = row_fix(lo, width)
    one = torch.ones(rows, dtype=torch.float32)
    scale = torch.ldexp(one, shift)[:, None]
    lim = torch.ldexp(one, e + 1)[:, None]            # inf for e = 128
    far = ~(x.abs() < lim)
    assert bool(((codes[far & (x < 0)] == 0).all()
                 & (codes[far & (x > 0)] == 255).all()))
    q = torch.round(x * scale).to(torch.int64)       # __float2ll_rn
    q = torch.where(far, 0, q)
    assert int(q.abs().max()) < 2**FIX_BITS
    # each element's 32-bit words: (block, warp, group of UNROLL float4
    # loads), as the kernel's grid lays the row out
    nblocks = -(-n // TILE)
    i = torch.arange(n)
    t = i % TILE
    it, tid = t // (4 * THREADS), (t % (4 * THREADS)) // 4
    groups = ITERS // UNROLL
    word = ((i // TILE) * (THREADS // 32) + tid // 32) * groups + it // UNROLL
    nwords = nblocks * (THREADS // 32) * groups
    low, high = q & (2**LO_BITS - 1), q >> LO_BITS
    fixed = torch.empty((rows, 256), dtype=torch.float64)
    for r in range(rows):
        key = word * 256 + codes[r].long()
        wl = torch.zeros(nwords * 256, dtype=torch.int64).index_add_(
            0, key, low[r])
        wh = torch.zeros(nwords * 256, dtype=torch.int64).index_add_(
            0, key, high[r])
        assert int(wl.max()) < 2**32                 # u32 words
        assert -2**31 <= int(wh.min()) and int(wh.max()) < 2**31
        warp = (wh * 2**LO_BITS + wl).view(-1, groups, 256).sum(1)
        assert int(warp.abs().max()) < 2**59         # a warp's int64 sums
        block = warp.view(nblocks, THREADS // 32, 256).sum(1)
        assert int(block.abs().max()) < 2**62
        glow = (block & 0xFFFFFFFF).sum(0)           # global atomics
        ghigh = (block >> 32).sum(0)
        assert int(glow.max()) < 2**47 and int(ghigh.abs().max()) < 2**45
        fixed[r] = ghigh.double() * 2.0**32 + glow.double()
    sums = torch.ldexp(fixed, -shift[:, None].double())
    xd = torch.where(far, x, 0.0).double()
    sums[:, 0] += torch.where(xd < 0, xd, 0.0).sum(1)
    sums[:, 255] += torch.where(xd > 0, xd, 0.0).sum(1)
    return sums.float()


def _put(x, rng, values):
    """Write ``values`` at random places of ``x`` (as many as fit)."""
    values = np.asarray(values, np.float64)[:x.size]
    x[rng.permutation(x.size)[:values.size]] = values


def _row(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.normal(0.01, 1.0, n)
        _put(x, rng, [40.0, -35.0, 0.0])
    elif kind == "constant":
        x = np.full(n, 0.5)
    elif kind == "zeros":                            # the scale = 0 worker
        x = np.zeros(n)
    elif kind == "one_bucket":                       # all but a few
        x = np.full(n, 0.25)
        _put(x, rng, rng.normal(0.0, 1e-3, 8))
    elif kind == "tiny":
        # exact zeros and values 6 decades below the range bound, in
        # buckets of their own: the bulk lies away from 0
        x = np.sign(rng.normal(size=n)) * (1.0 + np.abs(rng.normal(size=n)))
        pick = rng.random(n)
        x[pick < 0.3] = 0.0
        tiny = (pick >= 0.3) & (pick < 0.6)
        x[tiny] = np.sign(rng.normal(size=tiny.sum())) * 8e-6 * (
            1.0 + rng.random(tiny.sum()))
    elif kind == "outliers":                         # +-1e6 sigma clipped
        x = rng.normal(0.0, 1.0, n)
        _put(x, rng, [1e6, -1e6, 3e6, -2e6, 1e6, -5e5])
    elif kind == "heavy_tail":
        x = rng.standard_t(2.0, n)
        _put(x, rng, [1e4, -3e4])
    else:
        raise ValueError(kind)
    return x.astype(np.float32)


KINDS = ["normal", "constant", "zeros", "one_bucket", "tiny", "outliers",
         "heavy_tail"]


def _check(x, lo, width):
    codes = tref.encode(x, lo, width)
    got = fixed_point_sums(x, codes, lo, width)
    want, counts = tref.bucket_stats(x, codes)
    abs_sums = tref.bucket_stats(x.abs(), codes)[0]
    assert bool(((got - want).abs() <= 1e-4 * abs_sums).all())
    return codes, got, counts


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 1000, 2 * TILE + 3])
def test_fixed_point_sums_within_check(kind, n):
    x = torch.from_numpy(np.stack([_row(kind, n, n), 3.0 * _row(kind, n, 7)]))
    lo, width = tref.quant_params(x)
    _check(x, lo, width)


@pytest.mark.parametrize("kind", KINDS)
def test_fixed_point_codebook_matches_jax(kind):
    """Given the reference's lo and width the codes are the reference's,
    and the model's codebook is within the reference test's tolerance."""
    x = _row(kind, 2 * TILE + 3, 11)
    jq = jref.quantize(jnp.asarray(x))
    jlo, jwidth = jref.quant_params(jnp.asarray(x))
    lo = torch.tensor([float(jlo)])
    width = torch.tensor([float(jwidth)])
    codes, sums, counts = _check(torch.from_numpy(x)[None], lo, width)
    np.testing.assert_array_equal(codes[0].numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(
        counts[0].numpy(), np.bincount(np.asarray(jq.codes), minlength=256))
    book = tref.make_codebook(sums, counts, lo, width)[0].numpy()
    np.testing.assert_allclose(book, np.asarray(jq.codebook), rtol=1e-5,
                               atol=1e-6 * float(jwidth))


def test_fixed_point_pseudograd_rows():
    """The fused encode's input, scale * (anchor - theta), with a zero
    scale (a constant row of zeros) beside scaled rows."""
    rng = np.random.default_rng(3)
    anchor = torch.from_numpy(rng.normal(size=(3, 70001)).astype(np.float32))
    theta = anchor + 0.01 * torch.from_numpy(
        rng.normal(size=(3, 70001)).astype(np.float32))
    pg = tref.pseudograd(anchor, theta, torch.tensor([1.0, 0.0, 2.5]))
    lo, width = tref.quant_params(pg)
    codes, sums, counts = _check(pg, lo, width)
    assert int(counts[1, 0]) == 70001 and float(sums[1].abs().max()) == 0.0


def test_fixed_point_past_2_24_in_one_bucket():
    """More than 2^24 elements in one bucket (where fp32 counts stop and
    the fixed-point words are fullest) and far outliers on both sides."""
    n = (1 << 24) + TILE + 5
    x = torch.full((1, n), 0.25)
    x[0, :4] = torch.tensor([1.0, -1.0, 2.0, -0.75])
    lo, width = tref.quant_params(x)
    codes, sums, counts = _check(x, lo, width)
    assert int(counts.max()) == n - 4 > 2**24
    shift, e = row_fix(lo, width)
    assert float(x[0, 0]) >= 2.0 ** int(e[0] + 1)    # took the far path


@pytest.mark.parametrize("kind", ["normal", "tiny", "outliers"])
def test_fixed_point_error_bound(kind):
    """|sum - exact| <= count 2^-45 r + 2^-24 |exact| + count 2^-53
    sum|x|, the bound the source's header states."""
    x = torch.from_numpy(_row(kind, 2 * TILE + 3, 5))[None]
    lo, width = tref.quant_params(x)
    codes = tref.encode(x, lo, width)
    got = fixed_point_sums(x, codes, lo, width).double()
    exact, counts = tref.bucket_stats(x, codes)
    c = codes[0].long()
    exact = torch.zeros(256, dtype=torch.float64).index_add_(
        0, c, x[0].double())
    abs_sum = torch.zeros(256, dtype=torch.float64).index_add_(
        0, c, x[0].double().abs())
    r = float(torch.maximum(lo.abs(), (lo + 256.0 * width).abs()))
    n_b = counts[0].double()
    bound = n_b * 2.0**-45 * r + 2.0**-24 * exact.abs() + n_b * 2.0**-53 \
        * abs_sum
    assert bool(((got[0] - exact).abs() <= bound).all())


def test_model_constants_match_the_source():
    src = SOURCE.read_text()

    def define(name):
        return re.search(rf"#define {name} \(?(-?\w+)", src).group(1)
    assert define("FIX_BITS") == str(FIX_BITS)
    assert define("FIX_EXP_MIN") == str(FIX_EXP_MIN)
    assert define("LO_BITS") == str(LO_BITS)
    assert define("ENC_THREADS") == str(THREADS)
    assert define("ENC_ITERS") == str(ITERS)
    assert define("ENC_UNROLL") == str(UNROLL)
    # a word takes UNROLL * 4 terms a lane between flushes
    assert 32 * UNROLL * 4 * 2**LO_BITS <= 2**32
    assert 32 * UNROLL * 4 * 2**(FIX_BITS - LO_BITS) <= 2**31
