"""The flash-decode kernel's block variant (``kernels.flash_decode.
flash_decode_partial``: the dense kernel over one block of a cache,
writing each query head's log-sum-exp) against its plain version on the
card: out within the kernel's tolerance, lse within 1e-5, empty slots 0
and -inf, a repeat bitwise, ``out`` bitwise the plain kernel's, and the
merged blocks of a wrapped ring equal to the whole-ring kernel. Needs a
CUDA device and nvcc (skipped without a device); imports no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_flash_decode_partial_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.models import attention as attn

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# (B, S_blk, Hk, G, dh, lengths): INTELLECT-1's rank block of phase 16,
# h2o-danube's production block, odd head dims
CASES = [
    (4, 512, 8, 4, 128, [0, 1, 300, 512]),
    (8, 256, 8, 4, 80, [0, 256, 17, 200, 1, 255, 0, 128]),
    (3, 64, 2, 3, 24, [64, 0, 33]),
    (2, 100, 1, 8, 256, [100, 7]),
]

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


def _inputs(b, s, hk, g, dh, dtype, length, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, 1, hk * g, dh), (b, s, hk, dh),
                             (b, s, hk, dh)))
    return q, k, v, torch.tensor(length, dtype=torch.int32, device="cuda")


@needs_cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_matches_plain(case, dtype):
    b, s, hk, g, dh, lengths = case
    q, k, v, length = _inputs(b, s, hk, g, dh, dtype, lengths)
    before = fd.flash_decode_partial.launches
    out, lse = fd.flash_decode_partial(q, k, v, length)
    again, lse2 = fd.flash_decode_partial(q, k, v, length)
    assert fd.flash_decode_partial.launches == before + 2
    ref, ref_lse = fd.flash_decode_partial_torch(q, k, v, length)
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    live = length > 0
    torch.testing.assert_close(lse[live], ref_lse[live], rtol=1e-5,
                               atol=1e-5)
    assert torch.isneginf(lse[~live]).all()
    assert (out[~live] == 0).all()
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    assert torch.equal(out, fd.flash_decode(q, k, v, length))


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapped_ring_in_blocks_equals_the_ring_kernel(dtype):
    w, blk = 4096, 256
    q, k, v, length = _inputs(8, w, 8, 4, 80, dtype,
                              [1, 200, 4095, 4096, 4097, 5000, 8191, 12345])
    outs, lses = [], []
    for off in range(0, w, blk):
        o, l = fd.flash_decode_partial(
            q, k[:, off:off + blk].contiguous(),
            v[:, off:off + blk].contiguous(),
            attn.block_length(length, off, blk, w))
        outs.append(o)
        lses.append(l)
    got = fd.merge_partials(outs, lses)
    want = fd.flash_decode(q, k, v, length, window=w)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@needs_cuda
def test_partial_refuses_what_the_kernel_does_not_take():
    q, k, v, length = _inputs(2, 64, 2, 2, 16, torch.float32, [3, 4])
    with pytest.raises(TypeError):
        fd.flash_decode_partial(q, k.half(), v, length)
    with pytest.raises(ValueError):
        fd.flash_decode_partial(q, k[:1], v[:1], length)
