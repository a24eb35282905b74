"""The hand-written CUDA flash-decode kernel against its plain PyTorch
version on the card. Needs a CUDA device and nvcc (skipped without a
device); imports no JAX, so it runs on the GPU machine:

  PYTHONPATH=src python -m pytest -q tests/test_torch_flash_decode_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import flash_decode as fd

# (B, S_max, Hk, G, dh) of tests/test_flash_decode.py, plus the serving
# shape of INTELLECT-1 and head dims 8, 24 and 256 (every lanes-per-cell
# instance of the kernel: 1, 2, 4, 8, 16, 32)
CASES = [
    (3, 64, 2, 4, 16),
    (2, 40, 1, 1, 32),
    (1, 128, 4, 3, 64),
    (2, 300, 2, 2, 128),
    (4, 512, 8, 4, 128),
    (2, 70, 2, 5, 24),
    (2, 50, 2, 3, 8),
    (2, 100, 1, 8, 256),
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


def _inputs(b, s, hk, g, dh, dtype, length, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, 1, hk * g, dh), generator=gen, device="cuda")
    k = torch.randn((b, s, hk, dh), generator=gen, device="cuda")
    v = torch.randn((b, s, hk, dh), generator=gen, device="cuda")
    length = torch.tensor(length, dtype=torch.int32, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype), length


def _check(q, k, v, length, window=None):
    out = fd.flash_decode(q, k, v, length, window=window)
    torch.cuda.synchronize()
    ref = fd.flash_decode_torch(q, k, v, length, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[q.dtype],
                               atol=TOL[q.dtype])
    return out


@needs_cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(case, dtype):
    b, s, hk, g, dh = case
    length = [s, 0, 1, s // 2 + 3][:b]
    before = fd.flash_decode.launches
    _check(*_inputs(b, s, hk, g, dh, dtype, length))
    assert fd.flash_decode.launches == before + 1


@needs_cuda
@pytest.mark.parametrize("length_off", list(range(-1, 10)))
def test_kernel_swa_wrap(length_off):
    b, s, hk, g, dh, window = 2, 32, 2, 2, 16, 24
    _check(*_inputs(b, s, hk, g, dh, torch.float32,
                    [s + length_off, max(0, s + length_off - 1)]),
           window=window)


@needs_cuda
def test_kernel_empty_slots_exactly_zero():
    q, k, v, length = _inputs(2, 64, 2, 2, 16, torch.bfloat16, [0, 0])
    out = _check(q, k, v, length)
    assert torch.equal(out, torch.zeros_like(out))


@needs_cuda
def test_kernel_on_layer_slice_of_stacked_cache():
    """Per-layer slices k[l], v[l], length[l] of the stacked cache
    ((L, B, S, Hk, dh) and (L, B)): length rows of an odd batch are not
    16-byte aligned, and need not be."""
    q, _, _, _ = _inputs(3, 96, 2, 4, 64, torch.bfloat16, [96, 50, 0])
    kk = torch.randn((3, 3, 96, 2, 64), device="cuda").bfloat16()
    vv = torch.randn((3, 3, 96, 2, 64), device="cuda").bfloat16()
    lens = torch.tensor([[1, 2, 3], [96, 50, 0], [4, 5, 6]],
                        dtype=torch.int32, device="cuda")
    _check(q, kk[1], vv[1], lens[1])


@needs_cuda
def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, length = _inputs(2, 64, 2, 2, 16, torch.float32, [3, 4])
    with pytest.raises(ValueError, match="contiguous"):
        fd.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                        v, length)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k.half(), v.half(), length)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k, v, length.long())
    with pytest.raises(ValueError, match="multiple of 8"):
        fd.flash_decode(q[..., :12].contiguous(), k[..., :12].contiguous(),
                        v[..., :12].contiguous(), length)
    with pytest.raises(ValueError):
        fd.flash_decode(q, k.cpu(), v, length)
