"""The hand-written CUDA int8 codec kernels against their plain PyTorch
versions on the card. Needs a CUDA device and nvcc (skipped without a
device); imports no JAX, so it runs on the GPU machine:

  PYTHONPATH=src python -m pytest -q tests/test_torch_int8_quant_cuda.py

Codes and counts are exact; sums and codebooks are allclose (the
plain version sums in fp64, the kernel in fp32 in its own fixed
order); a second call is bitwise
equal to the first (the histogram has no atomics); decode and
decode_add are exact.
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


def _check_encode(x, got, want, again):
    """Sums within 1e-4 of the bucket's sum of |x| of the plain
    version's, which adds in fp64 (the kernel adds in fp32, at most a
    few thousand terms in a row)."""
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
