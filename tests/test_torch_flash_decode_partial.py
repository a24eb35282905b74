"""The flash-decode block variant's plain version
(``kernels.flash_decode.flash_decode_partial_torch``, the CPU path of
its wrapper) and ``merge_partials``: a cache cut into 1-4 blocks by
sequence, each block attended with ``attention.block_length`` live
cells and no window, the partials merged, equals ``repro``'s
``decode_attention`` over the whole cache within 1e-5, for random
lengths (empty blocks included) and for wrapped SWA rings (the ring is
never wider than its window). A wrapped h2o-danube ring at its
production decode block (Hq 32, Hk 8, dh 80, 4096 cells in blocks of
256) equals the whole-ring kernel path (``flash_decode_torch`` with the
window). The kernel against this plain version on the card:
``test_torch_flash_decode_partial_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_decode as tfd
from repro_torch.models import attention as tattn

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(2)


def _blocks(q, k, v, length, n, s_ring):
    """The block variant on each of n blocks, then the merge."""
    blk = k.shape[1] // n
    outs, lses = [], []
    for r in range(n):
        off = r * blk
        o, l = tfd.flash_decode_partial(
            q, k[:, off:off + blk], v[:, off:off + blk],
            tattn.block_length(length, off, blk, s_ring))
        assert o.dtype == q.dtype and l.dtype == torch.float32
        outs.append(o)
        lses.append(l)
    return tfd.merge_partials(outs, lses), lses


def _case(seed, b, s, hk, g, dh, window):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, hk * g, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, hk, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, hk, dh)).astype(np.float32)
    hi = 3 * s if window else s
    length = rng.integers(1, hi + 1, size=b).astype(np.int32)
    length[0] = 1                      # every later block empty
    return q, k, v, length


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("window", [None, 48], ids=["causal", "ring"])
def test_blocks_merge_to_reference(n, window):
    s = 48 if window else 96            # a ring of min(max_len, window)
    q, k, v, length = _case(n + (window or 0), 5, s, 2, 3, 16, window)
    t = [torch.from_numpy(a) for a in (q, k, v, length)]
    out, lses = _blocks(*t, n, s)
    ref = jattn.decode_attention(
        jnp.asarray(q), jattn.KVCache(jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(length)),
        window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if n > 1:                           # slot 0 holds one cell: block 0
        assert all(torch.isinf(l[0]).all() for l in lses[1:])
        assert torch.isfinite(lses[0][0]).all()


def test_one_block_is_the_plain_kernel_with_its_lse():
    q, k, v, length = _case(7, 4, 64, 2, 4, 32, None)
    length[1] = 0                       # an empty slot: out 0, lse -inf
    t = [torch.from_numpy(a) for a in (q, k, v, length)]
    out, lse = tfd.flash_decode_partial(*t)
    assert torch.equal(out, tfd.flash_decode_torch(*t))
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.isneginf(lse[1]).all()
    s = torch.einsum("bhd,bshd->bhs", t[0][:, 0].reshape(4, 2, 4, 32)
                     .reshape(4, 8, 32),
                     t[1].repeat_interleave(4, dim=2)) * 32 ** -0.5
    live = torch.arange(64)[None, None] < t[3][:, None, None]
    want = torch.logsumexp(s.masked_fill(~live, float("-inf")), dim=-1)
    torch.testing.assert_close(lse[[0, 2, 3]], want[[0, 2, 3]], rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapped_danube_ring_in_blocks_equals_the_ring_kernel(dtype):
    """h2o-danube-1.8b's decode: a rank's 8 rows, 32 query heads on 8 kv
    heads of 80, its 4096-cell window ring wrapped, split in 16 blocks
    of 256 (its 'model' axis of 16)."""
    w, blk = 4096, 256
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(8, 1, 32, 80))).to(dtype)
    k = torch.from_numpy(rng.normal(size=(8, w, 8, 80))).to(dtype)
    v = torch.from_numpy(rng.normal(size=(8, w, 8, 80))).to(dtype)
    length = torch.tensor([1, 200, 4095, 4096, 4097, 5000, 8191, 12345],
                          dtype=torch.int32)
    out, _ = _blocks(q, k, v, length, w // blk, w)
    want = tfd.flash_decode_torch(q, k, v, length, window=w)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
