"""The hand-written CUDA int8 codec kernels against their plain PyTorch
versions on the card. Needs a CUDA device and nvcc (skipped without a
device); imports no JAX, so it runs on the GPU machine:

  PYTHONPATH=src python -m pytest -q tests/test_torch_int8_quant_cuda.py

Codes and counts are exact; sums are within 1e-4 of their bucket's sum
of |x| of the plain version's, which adds in fp64 (the kernel adds
64-bit fixed-point integers, each term off by at most 2^-45 of the
row's range bound: the source's header gives the bound). The histogram
uses integer atomics, whose order cannot change an integer total, so a
second call, and a third on fresh copies of the inputs, are bitwise
equal to the first. Besides Gaussian rows the encode is held on rows the
ring can meet: a constant row, a row of zeros (a worker whose scale is
0), one bucket holding all but a few elements, exact zeros beside values
6 decades below the range bound, clipped outliers of +-1e6 sigma on both
sides, a heavy tail, and a row of more than 2^24 elements with more than
2^24 in one bucket. decode and decode_add are exact.
"""
import pytest
import torch

from repro_torch.kernels import int8_quant as iq
from repro_torch.kernels import ops, ref

# (rows, n): odd n, n < 16, n not a multiple of 16 bytes, several rows,
# more than one encode tile, and rows whose base is not 16-byte aligned
SHAPES = [(1, 1), (1, 7), (2, 15), (3, 127), (1, 4096), (2, 1_000_003),
          (2, 3 * 65536 + 5), (4, 1 << 20)]

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


def _rows(rows, n, seed=0, offset=0):
    """Normal rows with outliers; ``offset`` elements into a buffer, so a
    non-zero offset leaves the rows unaligned."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn(rows * n + offset, generator=gen, device="cuda")
    x = buf[offset:].view(rows, n)
    x[:, 0] = 50.0
    return x.mul_(torch.arange(1, rows + 1, device="cuda")[:, None])


def _adversarial(kind, rows, n, seed=0):
    """Rows the ring can meet beside Gaussian ones (module docstring)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def put(x, values):
        """``values`` at random places of every row."""
        values = torch.tensor(values, device="cuda")
        for r in range(rows):
            at = torch.randperm(n, generator=gen, device="cuda")[:len(values)]
            x[r, at] = values[:len(at)]
    if kind == "constant":
        return torch.full((rows, n), 0.5, device="cuda")
    if kind == "zeros":
        return torch.zeros((rows, n), device="cuda")
    if kind == "one_bucket":
        x = torch.full((rows, n), 0.25, device="cuda")
        put(x, [1e-3, -2e-3, 5e-4, 3e-3, -1e-3, 0.0, 2e-3, -4e-3])
        return x
    if kind == "tiny":                 # bulk away from 0: 0's bucket holds
        x = randn(rows, n)             # only zeros and 1e-6 r values
        x = torch.sign(x) * (1.0 + randn(rows, n).abs())
        pick = torch.rand((rows, n), generator=gen, device="cuda")
        tiny = 8e-6 * torch.sign(randn(rows, n)) * (1.0 + pick)
        x = torch.where(pick < 0.6, tiny, x)
        return torch.where(pick < 0.3, 0.0, x)
    if kind == "outliers":
        x = randn(rows, n)
        put(x, [1e6, -1e6, 3e6, -2e6, 1e6, -5e5])
        return x
    if kind == "heavy_tail":           # Student-t, 2 degrees of freedom
        z, w = randn(rows, n), randn(rows, n)
        x = z / torch.sqrt((w * w + randn(rows, n) ** 2) / 2.0)
        put(x, [1e4, -3e4])
        return x
    raise ValueError(kind)


KINDS = ["constant", "zeros", "one_bucket", "tiny", "outliers", "heavy_tail"]
# two rows with a ragged tail; one row past 2^24 elements
ADV_SHAPES = [(2, 3 * 65536 + 5), (1, (1 << 24) + 65536 + 5)]


def _check_encode(x, got, want, again):
    """Sums within 1e-4 of the bucket's sum of |x| of the plain
    version's, which adds in fp64."""
    codes, sums, counts = got
    wc, ws, wn = want
    assert codes.dtype == torch.uint8 and counts.dtype == torch.int32
    assert torch.equal(codes, wc)
    assert torch.equal(counts, wn)
    abs_sums = ref.bucket_stats(x.abs(), codes)[0]
    assert bool(((sums - ws).abs() <= 1e-4 * abs_sums).all())
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@needs_cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_encode_hist_matches_plain(shape, offset):
    x = _rows(*shape, offset=offset)
    lo, width = ref.quant_params(x)
    before = iq.encode_hist.launches
    got = iq.encode_hist(x, lo, width)
    again = iq.encode_hist(x, lo, width)
    torch.cuda.synchronize()
    assert iq.encode_hist.launches == before + 2
    _check_encode(x, got, iq.encode_hist_torch(x, lo, width), again)


@needs_cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scale", [None, "rows"])
def test_pseudograd_encode_hist_matches_plain(shape, scale):
    anchor = _rows(*shape, seed=1)
    theta = anchor + 0.01 * _rows(*shape, seed=2)
    s = None
    if scale == "rows":
        s = torch.linspace(0.0, 1.5, shape[0], device="cuda")
    lo, width = ref.quant_params(ref.pseudograd(anchor, theta, s))
    before = iq.pseudograd_encode_hist.launches
    got = iq.pseudograd_encode_hist(anchor, theta, lo, width, scale=s)
    again = iq.pseudograd_encode_hist(anchor, theta, lo, width, scale=s)
    torch.cuda.synchronize()
    assert iq.pseudograd_encode_hist.launches == before + 2
    _check_encode(ref.pseudograd(anchor, theta, s), got,
                  iq.pseudograd_encode_hist_torch(anchor, theta, lo, width,
                                                  scale=s), again)


@needs_cuda
@pytest.mark.parametrize("shape", ADV_SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_encode_hist_adversarial_rows(kind, shape):
    x = _adversarial(kind, *shape)
    lo, width = ref.quant_params(x)
    got = iq.encode_hist(x, lo, width)
    again = iq.encode_hist(x, lo, width)
    torch.cuda.synchronize()
    want = iq.encode_hist_torch(x, lo, width)
    _check_encode(x, got, want, again)
    if kind in ("constant", "one_bucket", "zeros") and shape[1] > 1 << 24:
        assert int(got[2].max()) > 1 << 24          # int32 counts


@needs_cuda
@pytest.mark.parametrize("kind", KINDS)
def test_pseudograd_encode_hist_adversarial_rows(kind):
    """scale * (anchor - 0) with scales 1 and 0: the second row is the
    all-zero row of a worker whose scale is 0."""
    anchor = _adversarial(kind, *ADV_SHAPES[0], seed=1)
    theta = torch.zeros_like(anchor)
    s = torch.tensor([1.0, 0.0], device="cuda")
    pg = ref.pseudograd(anchor, theta, s)
    lo, width = ref.quant_params(pg)
    got = iq.pseudograd_encode_hist(anchor, theta, lo, width, scale=s)
    again = iq.pseudograd_encode_hist(anchor, theta, lo, width, scale=s)
    torch.cuda.synchronize()
    _check_encode(pg, got, iq.pseudograd_encode_hist_torch(
        anchor, theta, lo, width, scale=s), again)
    assert int(got[2][1, 0]) == ADV_SHAPES[0][1]     # the zero row


@needs_cuda
@pytest.mark.parametrize("fused", [False, True])
def test_third_call_on_fresh_allocation_bitwise_equal(fused):
    """After the allocator has moved on, fresh copies of the inputs give
    the first call's bits: the atomics' order cannot show."""
    x = _rows(2, 1_000_003, seed=6)
    anchor = _rows(2, 1_000_003, seed=7) if fused else None
    s = torch.tensor([1.0, 0.5], device="cuda")

    def call(x, anchor):
        src = x if anchor is None else ref.pseudograd(anchor, x, s)
        lo, width = ref.quant_params(src)
        if anchor is None:
            return iq.encode_hist(x, lo, width)
        return iq.pseudograd_encode_hist(anchor, x, lo, width, scale=s)
    first = [t.clone() for t in call(x, anchor)]
    call(x, anchor)
    spacer = torch.empty(12345679, dtype=torch.uint8, device="cuda")
    x3 = x.clone()
    a3 = None if anchor is None else anchor.clone()
    third = call(x3, a3)
    torch.cuda.synchronize()
    assert x3.data_ptr() != x.data_ptr()
    for a, b in zip(first, third):
        assert torch.equal(a, b)
    del spacer


@needs_cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_decode_and_decode_add_exact(shape, offset):
    rows, n = shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    buf = torch.randint(0, 256, (rows * n + offset,), generator=gen,
                        device="cuda", dtype=torch.uint8)
    codes = buf[offset:].view(rows, n)
    book = torch.randn((rows, 256), generator=gen, device="cuda")
    out = iq.decode(codes, book)
    assert torch.equal(out, iq.decode_torch(codes, book))
    acc = _rows(rows, n, seed=4, offset=offset)
    want = acc + iq.decode_torch(codes, book)
    got = iq.decode_add(codes, book, acc)
    torch.cuda.synchronize()
    assert got.data_ptr() == acc.data_ptr()          # in place
    assert torch.equal(got, want)


@needs_cuda
def test_quantize_roundtrip_matches_plain():
    x = _rows(2, 100_003, seed=5)
    q, qr = ops.quantize(x), ref.quantize(x)
    assert torch.equal(q.codes, qr.codes)
    torch.testing.assert_close(q.codebook, qr.codebook, rtol=1e-4,
                               atol=1e-6)
    torch.testing.assert_close(ops.dequantize(q), ref.dequantize(q))
    c = torch.full((1, 1000), 0.5, device="cuda")           # constant row
    assert torch.equal(ops.quantize(c).codes, ref.quantize(c).codes)


@needs_cuda
def test_wrappers_reject_what_the_kernels_do_not_take():
    x = _rows(2, 64)
    lo, width = ref.quant_params(x)
    with pytest.raises(ValueError, match="contiguous"):
        iq.encode_hist(x.t().contiguous().t(), lo, width)
    with pytest.raises(TypeError):
        iq.encode_hist(x.double(), lo, width)
    with pytest.raises(ValueError):
        iq.encode_hist(x, lo.cpu(), width)
    with pytest.raises(ValueError):
        iq.encode_hist(x[0], lo, width)
    codes = torch.zeros((2, 64), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):
        iq.decode(codes, torch.zeros((1, 256), device="cuda"))
    with pytest.raises(TypeError):
        iq.decode_add(codes, torch.zeros((2, 256), device="cuda"),
                      torch.zeros((2, 64), device="cuda").half())
