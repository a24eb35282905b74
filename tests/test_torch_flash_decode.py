"""repro_torch's flash-decode plain version (the CPU path of the kernel
wrapper) against repro's decode_attention, both through the Pallas
kernel in interpret mode and through the jnp path, on numpy-seeded
inputs. Does not use the session-scoped ``rng`` fixture."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.convert import to_tensor
from repro_torch.kernels import flash_decode as tfd
from repro_torch.models import attention as tattn

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

# (B, S_max, Hk, G, dh): the cases of tests/test_flash_decode.py
CASES = [
    (3, 64, 2, 4, 16),
    (2, 40, 1, 1, 32),
    (1, 128, 4, 3, 64),
    (2, 300, 2, 2, 128),
]


def _inputs(rng, b, s, hk, g, dh, dtype, length):
    q = jnp.asarray(rng.normal(size=(b, 1, hk * g, dh)), dtype)
    k = jnp.asarray(rng.normal(size=(b, s, hk, dh)), dtype)
    v = jnp.asarray(rng.normal(size=(b, s, hk, dh)), dtype)
    cache = jattn.KVCache(k, v, jnp.asarray(length, jnp.int32))
    t = [to_tensor(np.asarray(a), "cpu") for a in (q, k, v, cache.length)]
    return q, cache, t


def _close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_jnp(case, dtype):
    b, s, hk, g, dh = case
    rng = np.random.default_rng(sum(case))
    length = rng.integers(0, s + 1, size=b)
    length[0] = s
    q, cache, (tq, tk, tv, tlen) = _inputs(rng, b, s, hk, g, dh,
                                           getattr(jnp, dtype), length)
    out = tfd.flash_decode(tq, tk, tv, tlen)      # CPU: the plain version
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = 1e-5 if dtype == "float32" else 3e-2
    _close(out, jattn.decode_attention(q, cache, impl="pallas"), tol)
    _close(out, jattn.decode_attention(q, cache, impl="jnp"), tol)


@pytest.mark.parametrize("length_off", list(range(-1, 10)))
def test_swa_wrap_lengths(length_off):
    """Rolling-ring masking around the wrap: length s_max-1 .. s_max+9."""
    b, s, hk, g, dh, window = 2, 32, 2, 2, 16, 24
    rng = np.random.default_rng(7)
    q, cache, (tq, tk, tv, tlen) = _inputs(
        rng, b, s, hk, g, dh, jnp.float32,
        [s + length_off, max(0, s + length_off - 1)])
    out = tfd.flash_decode(tq, tk, tv, tlen, window=window)
    _close(out, jattn.decode_attention(q, cache, window=window,
                                       impl="pallas"), 1e-5)
    mask = tattn.decode_valid_mask(tlen, s, window).numpy()
    np.testing.assert_array_equal(
        mask, np.asarray(jattn.decode_valid_mask(cache.length, s, window)))


def test_empty_slot_is_exactly_zero():
    b, s, hk, g, dh = 2, 64, 2, 2, 16
    rng = np.random.default_rng(5)
    _, _, (tq, tk, tv, _) = _inputs(rng, b, s, hk, g, dh, jnp.float32,
                                    [0, 0])
    out = tfd.flash_decode(tq, tk, tv, torch.tensor([0, 17],
                                                    dtype=torch.int32))
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert out[1].abs().sum() > 0


def test_cpu_path_counts_no_launch():
    """The launch counter moves only when the kernel launches."""
    before = tfd.flash_decode.launches
    q = torch.zeros((1, 1, 2, 8))
    kv = torch.zeros((1, 4, 1, 8))
    tfd.flash_decode(q, kv, kv, torch.tensor([2], dtype=torch.int32))
    assert tfd.flash_decode.launches == before
