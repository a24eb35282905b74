"""repro_torch's paged flash-decode plain version (the CPU path of the
kernel wrapper) against repro's ``flash_decode_paged`` Pallas kernel in
interpret mode, on numpy-seeded inputs over a PERMUTED block pool (trash
block 0 filled with noise, -1 table entries past the live blocks), and
bitwise against the port's dense plain version on the gathered view."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro_torch.convert import to_tensor
from repro_torch.kernels import flash_decode as tfd
from repro_torch.models import attention as tattn

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

# ((B, S_max, Hk, G, dh), blk): the cases of tests/test_flash_decode.py
CASES = [((3, 64, 2, 4, 16), 16),
         ((2, 40, 1, 1, 32), 8),
         ((1, 128, 4, 3, 64), 32)]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _paged_inputs(rng, b, s, hk, g, dh, blk, dtype, length, unmap=True):
    """numpy q, pool k/v (permuted, block 0 = noisy trash), table, length
    as (JAX arrays, port tensors)."""
    nb = s // blk
    q = rng.normal(size=(b, 1, hk * g, dh))
    kp = rng.normal(size=(b * nb + 1, blk, hk, dh))
    vp = rng.normal(size=(b * nb + 1, blk, hk, dh))
    table = rng.permutation(np.arange(1, b * nb + 1)).reshape(b, nb)
    length = np.asarray(length, np.int32)
    if unmap:
        for bi in range(b):
            table[bi, -(-int(length[bi]) // blk):] = -1
    arrs = [jnp.asarray(a, dtype) for a in (q, kp, vp)] + [
        jnp.asarray(table, jnp.int32), jnp.asarray(length)]
    return arrs, [to_tensor(np.asarray(a), "cpu") for a in arrs]


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _dense_on_view(tq, tkp, tvp, ttable, tlen, window=None):
    view = tattn.paged_view(tattn.PagedKVCache(tkp, tvp, ttable, tlen))
    return tfd.flash_decode(tq, view.k, view.v, tlen, window=window)


@pytest.mark.parametrize("case,blk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_pallas(case, blk, dtype):
    b, s, hk, g, dh = case
    rng = np.random.default_rng(sum(case) + blk)
    length = rng.integers(0, s + 1, size=b)
    length[0] = s
    jin, tin = _paged_inputs(rng, b, s, hk, g, dh, blk,
                             getattr(jnp, dtype), length)
    out = tfd.flash_decode_paged(*tin)        # CPU: the plain version
    assert out.dtype == tin[0].dtype and out.shape == tin[0].shape
    _close(out, jfd.flash_decode_paged(*jin), TOL[dtype])
    assert torch.equal(out, _dense_on_view(*tin))


@pytest.mark.parametrize("length_off", [-1, 0, 1, 5, 9])
def test_paged_swa_wrap(length_off):
    """SWA ring over the virtual cells, lengths around the wrap."""
    b, s, hk, g, dh, window, blk = 2, 32, 2, 2, 16, 24, 16
    rng = np.random.default_rng(11 + length_off)
    jin, tin = _paged_inputs(
        rng, b, s, hk, g, dh, blk, jnp.float32,
        [s + length_off, max(0, s + length_off - 1)], unmap=False)
    out = tfd.flash_decode_paged(*tin, window=window)
    _close(out, jfd.flash_decode_paged(*jin, window=window), 1e-5)
    assert torch.equal(out, _dense_on_view(*tin, window=window))


def test_paged_empty_slot_is_exactly_zero():
    rng = np.random.default_rng(5)
    jin, tin = _paged_inputs(rng, 2, 64, 2, 2, 16, 16, jnp.float32, [0, 17])
    out = tfd.flash_decode_paged(*tin)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert out[1].abs().sum() > 0
    _close(out, jfd.flash_decode_paged(*jin), 1e-5)


def test_paged_cpu_path_counts_no_launch():
    before = tfd.flash_decode_paged.launches
    rng = np.random.default_rng(3)
    _, tin = _paged_inputs(rng, 1, 16, 1, 2, 8, 8, jnp.float32, [5])
    tfd.flash_decode_paged(*tin)
    assert tfd.flash_decode_paged.launches == before
