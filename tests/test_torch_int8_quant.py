"""repro_torch's int8 codec (kernels/ref.py, kernels/ops.py and the CPU
route of kernels/int8_quant.py) against repro.kernels.ref on the same
numpy-seeded inputs. The reference's own main path uses ``ref`` (its
``quant_impl`` default is ``"jnp"``), so the port is held against it,
never against the Pallas path.

Tolerances: given the same lo and width, codes are exact. Through the
full quantizer lo/width come from two frameworks' mean/std reductions
(rtol 1e-6), so a code may move by one, and only for an element within
1e-4 bucket widths of a bucket edge; codebooks are allclose (rtol 1e-5,
atol 1e-6 widths); counts and wire bytes are identical integers; decode
and decode_add are exact given the same codes and codebook."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import int8_quant, ops
from repro_torch.kernels import ref as tref

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

SIZES = [1, 127, 128 * 513, 2**17 + 3]


def _x(n, seed=0, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "const":
        return np.full((n,), 0.5, np.float32)
    x = rng.normal(0.01, 1.0, size=n).astype(np.float32)
    if n > 8:
        x[:3] = [40.0, -35.0, 0.0]           # outliers past the clip range
    return x


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))[None]


def _check_codes_near_edges(t_codes, j_codes, x, lo, width):
    t_codes = np.asarray(t_codes, np.int64)
    j_codes = np.asarray(j_codes, np.int64)
    diff = np.nonzero(t_codes != j_codes)[0]
    assert np.all(np.abs(t_codes[diff] - j_codes[diff]) == 1)
    pos = (x[diff].astype(np.float64) - lo) / width
    assert np.all(np.abs(pos - np.round(pos)) < 1e-4), pos
    return diff.size


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["normal", "const"])
def test_encode_exact_given_lo_width(n, kind):
    x = _x(n, seed=n, kind=kind)
    lo, width = jref.quant_params(jnp.asarray(x))
    want = np.asarray(jref.encode(jnp.asarray(x), lo, width))
    got = tref.encode(_t(x), torch.tensor([float(lo)]),
                      torch.tensor([float(width)]))[0]
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU route of the kernel wrapper is the same function
    codes, sums, counts = int8_quant.encode_hist(
        _t(x), torch.tensor([float(lo)]), torch.tensor([float(width)]))
    np.testing.assert_array_equal(codes[0].numpy(), want)
    js, jc = jref.bucket_stats(jnp.asarray(x), jnp.asarray(want))
    np.testing.assert_array_equal(counts[0].numpy(), np.asarray(jc))
    np.testing.assert_allclose(sums[0].numpy(), np.asarray(js),
                               rtol=1e-5, atol=1e-5)


def _check_quantized(q, jq, x, jlo, jwidth):
    lo, width = tref.quant_params(_t(x))
    np.testing.assert_allclose(float(lo), float(jlo), rtol=1e-6)
    np.testing.assert_allclose(float(width), float(jwidth), rtol=1e-6)
    flips = _check_codes_near_edges(q.codes[0].numpy(), jq.codes, x,
                                    float(jlo), float(jwidth))
    counts = np.bincount(q.codes[0].numpy(), minlength=256)
    jcounts = np.bincount(np.asarray(jq.codes), minlength=256)
    if flips == 0:
        np.testing.assert_array_equal(counts, jcounts)
    same = counts == jcounts
    np.testing.assert_allclose(q.codebook[0].numpy()[same],
                               np.asarray(jq.codebook)[same], rtol=1e-5,
                               atol=1e-6 * float(jwidth))
    assert q.wire_bytes == jq.wire_bytes
    return flips


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["normal", "const"])
def test_quantize_matches_reference(n, kind):
    x = _x(n, seed=n + 1, kind=kind)
    jq = jref.quantize(jnp.asarray(x))
    jlo, jwidth = jref.quant_params(jnp.asarray(x))
    q = ops.quantize(_t(x))
    assert q.codes.dtype == torch.uint8 and q.codes.shape == (1, n)
    assert _check_quantized(q, jq, x, jlo, jwidth) <= max(1, n // 10000)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("scale", [None, 0.5, 0.0])
def test_quantize_pseudograd_matches_reference(n, scale):
    rng = np.random.default_rng(n)
    anchor = rng.normal(size=n).astype(np.float32)
    theta = (anchor + 0.01 * rng.normal(size=n)).astype(np.float32)
    jq = jref.quantize_pseudograd(jnp.asarray(anchor), jnp.asarray(theta),
                                  scale=scale)
    pg = anchor - theta
    if scale is not None:
        pg = pg * np.float32(scale)
    jlo, jwidth = jref.quant_params(jnp.asarray(pg))
    s = None if scale is None else torch.tensor([scale])
    q = ops.quantize_pseudograd(_t(anchor), _t(theta), scale=s)
    assert _check_quantized(q, jq, pg, jlo, jwidth) <= max(1, n // 10000)
    # the plain oracle agrees with the fused route bit for bit
    qr = tref.quantize_pseudograd(_t(anchor), _t(theta), s)
    assert torch.equal(qr.codes, q.codes)
    assert torch.equal(qr.codebook, q.codebook)


@pytest.mark.parametrize("n", SIZES)
def test_dequantize_exact(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 256, size=n).astype(np.uint8)
    book = rng.normal(size=256).astype(np.float32)
    acc = rng.normal(size=n).astype(np.float32)
    jq = jref.Quantized(jnp.asarray(codes), jnp.asarray(book))
    q = tref.Quantized(torch.from_numpy(codes)[None],
                       torch.from_numpy(book)[None])
    np.testing.assert_array_equal(ops.dequantize(q)[0].numpy(),
                                  np.asarray(jref.dequantize(jq)))
    want = np.asarray(jnp.asarray(acc) + jref.dequantize(jq))
    t_acc = _t(acc)
    out = ops.dequantize_add(q, t_acc)
    assert out is t_acc                      # written in place
    np.testing.assert_array_equal(out[0].numpy(), want)


def test_rows_are_independent():
    """One call over (rows, n) equals one call per row."""
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(3, 1000)).astype(np.float32) * [[1], [5], [0.1]]
    xs = torch.from_numpy(xs.astype(np.float32))
    q = ops.quantize(xs)
    for r in range(3):
        qr = ops.quantize(xs[r:r + 1])
        assert torch.equal(q.codes[r], qr.codes[0])
        assert torch.equal(q.codebook[r], qr.codebook[0])
    assert q.wire_bytes == 3 * 1000 + 3 * 4 * 256
