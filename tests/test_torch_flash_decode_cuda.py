"""The hand-written CUDA flash-decode kernel (dense and paged) against its
plain PyTorch version on the card, a second call bitwise equal to the
first, and the paged kernel bitwise against the dense one. Needs a CUDA
device and nvcc (skipped without a device); imports no JAX, so it runs
on the GPU machine:

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
    """Against the plain version, and a repeat bitwise equal (every sum
    of the kernel runs in a fixed order)."""
    out = fd.flash_decode(q, k, v, length, window=window)
    again = fd.flash_decode(q, k, v, length, window=window)
    torch.cuda.synchronize()
    ref = fd.flash_decode_torch(q, k, v, length, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[q.dtype],
                               atol=TOL[q.dtype])
    assert torch.equal(out, again)
    return out


@needs_cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(case, dtype):
    b, s, hk, g, dh = case
    length = [s, 0, 1, s // 2 + 3][:b]
    before = fd.flash_decode.launches
    _check(*_inputs(b, s, hk, g, dh, dtype, length))
    assert fd.flash_decode.launches == before + 2


# long caches: lengths that end mid-tile and mid-range of a cluster block
# (S_max / 8 cells a block at full length)
LONG = [(4, 4096, 2, 4, 128, [4096, 4095, 2000, 1]),
        (4, 8192, 2, 4, 128, [8192, 4096 + 17, 2048 + 5, 1]),
        (2, 8192, 1, 5, 24, [3 * 1024 + 31, 8191])]


@needs_cuda
@pytest.mark.parametrize("case", LONG)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_long_cache(case, dtype):
    b, s, hk, g, dh, length = case
    _check(*_inputs(b, s, hk, g, dh, dtype, length, seed=s))


@needs_cuda
@pytest.mark.parametrize("case", [(2, 8, 2, 4, 16, [8, 3]),
                                  (3, 40, 2, 2, 32, [40, 33, 1]),
                                  (2, 8, 1, 1, 8, [5, 0])])
def test_kernel_cache_shorter_than_a_cluster_of_tiles(case):
    """S_max under FD_CLUSTER tiles: most blocks of every cluster empty."""
    b, s, hk, g, dh, length = case
    _check(*_inputs(b, s, hk, g, dh, torch.bfloat16, length))


@needs_cuda
@pytest.mark.parametrize("length", [[1, 33, 65, 97], [32, 64, 96, 224],
                                    [255, 257, 0, 511]])
def test_kernel_lengths_leaving_cluster_blocks_empty(length):
    """1-7 live tiles leave 7-1 blocks of a cluster with no range;
    whole-tile and one-past-a-tile lengths."""
    _check(*_inputs(4, 512, 8, 4, 128, torch.bfloat16, length))


@needs_cuda
@pytest.mark.parametrize("g", [1, 5, 8, 16, 20])
@pytest.mark.parametrize("dh", [8, 24, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_query_heads_per_kv_head(g, dh, dtype):
    """G = 1 leaves three consumer warps idle, 5 and 8 give warps two
    heads, 16 and 20 take one and two head groups of 16."""
    _check(*_inputs(2, 100, 2, g, dh, dtype, [100, 37], seed=g))


@needs_cuda
@pytest.mark.parametrize("length", [[4096 + 900, 4100], [4096, 1000]])
def test_kernel_swa_wrap_long(length):
    """An SWA ring of 4096 cells and a 1000-cell window: the live cells
    of a wrapped ring are two runs, the gap masked inside the tiles."""
    _check(*_inputs(2, 4096, 2, 4, 128, torch.bfloat16, length),
           window=1000)


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
def test_trace_phases_stamps_every_block_in_order():
    """The traced build at the serving shape: one row per block in
    (slot, kv head, rank) order, a block's stamps in phase order, tile
    stamps exactly on the blocks whose ``cluster_ranges`` range holds a
    tile (slot 1: the last rank; slots 2 and 3: every rank), and no
    launch counted."""
    length = [0, 1, 300, 512]
    q, k, v, ln = _inputs(4, 512, 8, 4, 128, torch.bfloat16, length)
    before = fd.flash_decode.launches
    stamps = fd.trace_phases(q, k, v, ln)
    assert fd.flash_decode.launches == before
    assert stamps.shape == (4 * 8 * fd.CLUSTER, len(fd.PHASES))
    always = [fd.PHASES.index(p) for p in ("entry", "q_ready",
                                           "last_tile_done", "partials_ready",
                                           "output_written", "exit")]
    assert (stamps[:, always] >= 0).all()
    assert (stamps[:, always].diff(dim=1) >= 0).all()
    tiled = stamps[:, fd.PHASES.index("first_tile_landed")] >= 0
    want = torch.zeros((4, 8, fd.CLUSTER), dtype=torch.bool)
    for slot, n in enumerate(length):
        for rank, (start, end) in enumerate(fd.cluster_ranges(n, 512)):
            want[slot, :, rank] = end > start
    assert torch.equal(tiled, want.flatten())
    t = stamps[tiled]
    landed = t[:, fd.PHASES.index("first_tile_landed")]
    assert (landed >= t[:, fd.PHASES.index("q_ready")]).all()
    assert (landed <= t[:, fd.PHASES.index("last_tile_done")]).all()


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


# -- flash_decode_paged -------------------------------------------------------


def _paged(k, v, length, blk, seed=0, unmap=True):
    """Scatter a dense cache (B, S, Hk, dh) into a pool with a PERMUTED
    physical layout: block 0 is the trash block (filled with noise, so a
    read of it would show), and table entries past each slot's live
    blocks are -1 when ``unmap``."""
    b, s, hk, dh = k.shape
    nb = s // blk
    gen = torch.Generator().manual_seed(seed)
    table = (torch.randperm(b * nb, generator=gen) + 1).reshape(b, nb)
    kp = torch.randn((b * nb + 1, blk, hk, dh), device=k.device).to(k.dtype)
    vp = torch.randn_like(kp)
    for bi in range(b):
        kp[table[bi]] = k[bi].reshape(nb, blk, hk, dh)
        vp[table[bi]] = v[bi].reshape(nb, blk, hk, dh)
        if unmap:
            table[bi, -(-int(length[bi]) // blk):] = -1
    return kp, vp, table.to(torch.int32).to(k.device)


def _check_paged(q, kp, vp, table, length, window=None):
    """The paged kernel against its plain version, and bitwise equal to
    the dense kernel on the gathered view."""
    from repro_torch.models.attention import PagedKVCache, paged_view
    before = fd.flash_decode_paged.launches
    out = fd.flash_decode_paged(q, kp, vp, table, length, window=window)
    again = fd.flash_decode_paged(q, kp, vp, table, length, window=window)
    torch.cuda.synchronize()
    assert fd.flash_decode_paged.launches == before + 2
    ref = fd.flash_decode_paged_torch(q, kp, vp, table, length,
                                      window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[q.dtype],
                               atol=TOL[q.dtype])
    assert torch.equal(out, again)
    view = paged_view(PagedKVCache(kp, vp, table, length))
    dense = fd.flash_decode(q, view.k.contiguous(), view.v.contiguous(),
                            length, window=window)
    assert torch.equal(out, dense)
    return out


@needs_cuda
@pytest.mark.parametrize("blk", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_matches_plain_and_dense(blk, dtype):
    """The serving shape (B=4, Hk=8, G=4, dh=128, 512 cells)."""
    length = [0, 1, 300, 512]
    q, k, v, ln = _inputs(4, 512, 8, 4, 128, dtype, length, seed=blk)
    _check_paged(q, *_paged(k, v, length, blk, seed=blk), ln)


@needs_cuda
@pytest.mark.parametrize("case,blk", [((3, 64, 2, 4, 16), 16),
                                      ((2, 40, 1, 1, 32), 8),
                                      ((1, 128, 4, 3, 64), 32),
                                      ((2, 96, 1, 8, 256), 32),
                                      ((2, 48, 2, 5, 24), 1)])
@pytest.mark.parametrize("unmap", [False, True])
def test_paged_kernel_bitwise_dense_permuted(case, blk, unmap):
    b, s, hk, g, dh = case
    length = [s, s // 2 + 3][:b] + [s // 3] * (b - 2)
    q, k, v, ln = _inputs(b, s, hk, g, dh, torch.bfloat16, length)
    _check_paged(q, *_paged(k, v, length, blk, unmap=unmap), ln)


@needs_cuda
@pytest.mark.parametrize("length_off", list(range(-1, 10)))
def test_paged_kernel_swa_wrap(length_off):
    b, s, hk, g, dh, window, blk = 2, 32, 2, 2, 16, 24, 8
    length = [s + length_off, max(0, s + length_off - 1)]
    q, k, v, ln = _inputs(b, s, hk, g, dh, torch.float32, length)
    _check_paged(q, *_paged(k, v, length, blk, unmap=False), ln,
                 window=window)


@needs_cuda
@pytest.mark.parametrize("blk", [8, 16, 32, 64])
def test_paged_kernel_long_bitwise_dense_permuted(blk):
    """8192 virtual cells on a permuted pool: ranges of 1024 cells a
    block, lengths ending mid-tile and mid-range."""
    length = [8192, 4096 + 17, 2048 + 5, 1]
    q, k, v, ln = _inputs(4, 8192, 2, 4, 128, torch.bfloat16, length,
                          seed=blk)
    _check_paged(q, *_paged(k, v, length, blk, seed=blk), ln)


@needs_cuda
@pytest.mark.parametrize("blk", [8, 16, 32, 64])
def test_paged_kernel_swa_wrap_long_bitwise_dense(blk):
    length = [4096 + 900, 4100]
    q, k, v, ln = _inputs(2, 4096, 2, 4, 128, torch.bfloat16, length)
    _check_paged(q, *_paged(k, v, length, blk, unmap=False), ln,
                 window=1000)


@needs_cuda
def test_paged_kernel_empty_and_released_slots():
    """Length 0 returns exactly 0; a released slot (table row all -1)
    still decoding reads trash block 0, as the plain version does."""
    q, k, v, _ = _inputs(3, 64, 2, 2, 16, torch.bfloat16, [0, 0, 0])
    kp, vp, table = _paged(k, v, [64, 64, 64], 16, unmap=False)
    table[1:] = -1
    out = _check_paged(q, kp, vp, table,
                       torch.tensor([0, 0, 40], dtype=torch.int32,
                                    device="cuda"))
    assert torch.equal(out[:2], torch.zeros_like(out[:2]))
    assert out[2].abs().sum() > 0


@needs_cuda
def test_paged_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, ln = _inputs(2, 64, 2, 2, 16, torch.float32, [3, 40])
    kp, vp, table = _paged(k, v, [3, 40], 16)
    flat = torch.empty(kp.numel() + 1, device="cuda")
    shifted = flat[1:].view(kp.shape)          # contiguous, 4-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        fd.flash_decode_paged(q, shifted, vp, table, ln)
    with pytest.raises(ValueError, match="contiguous"):
        fd.flash_decode_paged(
            q, kp.transpose(1, 2).contiguous().transpose(1, 2), vp, table,
            ln)
    with pytest.raises(TypeError, match="int32"):
        fd.flash_decode_paged(q, kp, vp, table.long(), ln)
    with pytest.raises(ValueError, match="contiguous"):
        fd.flash_decode_paged(q, kp, vp,
                              table.t().contiguous().t(), ln)
    with pytest.raises(ValueError):
        fd.flash_decode_paged(q, kp, vp, table.cpu(), ln)
    # 2^20 one-cell blocks: a block's table entries outgrow shared memory
    big = torch.full((2, 1 << 20), -1, dtype=torch.int32, device="cuda")
    one = torch.zeros((2, 1, 2, 16), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        fd.flash_decode_paged(q, one, one, big, ln)
