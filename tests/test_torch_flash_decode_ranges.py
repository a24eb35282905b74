"""How the flash-decode kernel (``repro_torch/kernels/csrc/flash_decode.cu``)
divides a slot's cache among the blocks of a cluster, modelled on the CPU.

The CUDA kernel runs only on the card. Its work split is plain integer
arithmetic, which ``flash_decode.cluster_ranges`` repeats: the live
prefix [0, min(length, S_max)) in tiles of ``TILE_CELLS`` cells, split
into ``CLUSTER`` contiguous runs of whole tiles in rank order. These
tests check that for random (length, window, S_max) the runs cover every
cell that ``decode_valid_mask`` marks live exactly once, that the
constants equal the source's ``#define``s, and that the kernel's
arithmetic on those runs (an online softmax over each block's live
tiles, dead cells contributing exactly nothing, the blocks' partials
combined in rank order) gives the
plain version's output and ``repro``'s ``decode_attention`` on numpy-
seeded inputs, in fp32 within 1e-5 (the tolerance of
``tests/test_torch_flash_decode.py``).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import flash_decode as fd
from repro_torch.models.attention import decode_valid_mask

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "flash_decode.cu")


def _cover(length, s_max, window):
    """How many ranges of the cluster hold each cell, and the live mask."""
    hits = np.zeros(s_max, np.int64)
    for start, end in fd.cluster_ranges(length, s_max):
        hits[start:end] += 1
    live = decode_valid_mask(torch.tensor([length]), s_max, window)[0]
    return hits, live.numpy()


@pytest.mark.parametrize("s_max", [8, 40, 64, 255, 256, 512, 4096, 8192])
def test_ranges_cover_every_live_cell_once(s_max):
    rng = np.random.default_rng(s_max)
    for _ in range(60):
        length = int(rng.integers(0, 3 * s_max + 2))
        window = (None if rng.random() < 0.4
                  else int(rng.integers(1, s_max + 1)))
        hits, live = _cover(length, s_max, window)
        assert (hits[live] == 1).all(), (length, window)
        assert hits.max() <= 1
        # nothing past the live prefix is ever in a range
        hi = min(length, s_max)
        assert not hits[-(-hi // fd.TILE_CELLS) * fd.TILE_CELLS:].any()


@pytest.mark.parametrize("length,s_max", [(0, 512), (1, 512), (300, 512),
                                          (512, 512), (8192, 8192),
                                          (4097, 8192), (2048, 8192),
                                          (1, 8192), (7, 8), (39, 40),
                                          (1000, 40)])
def test_ranges_are_whole_tiles_in_rank_order(length, s_max):
    ranges = fd.cluster_ranges(length, s_max)
    assert len(ranges) == fd.CLUSTER
    hi = min(length, s_max)
    n_tiles = -(-hi // fd.TILE_CELLS)
    sizes = []
    prev_end = 0
    for start, end in ranges:
        assert start == prev_end and start % fd.TILE_CELLS == 0
        assert start <= end <= s_max
        assert end % fd.TILE_CELLS == 0 or end == s_max
        sizes.append(-(-(end - start) // fd.TILE_CELLS))
        prev_end = end
    assert sum(sizes) == n_tiles
    # balanced: no block holds more than its share, rounded up
    assert max(sizes) <= -(-n_tiles // fd.CLUSTER)
    if n_tiles < fd.CLUSTER:        # short prefixes leave blocks empty
        assert sizes.count(0) == fd.CLUSTER - n_tiles


def test_model_constants_match_the_source():
    src = SOURCE.read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", src).group(1))
    assert define("FD_TILE") == fd.TILE_CELLS
    assert define("FD_CLUSTER") == fd.CLUSTER
    assert define("FD_STAGES") == fd.STAGES
    assert define("FD_MAX_SMEM") == fd.MAX_SMEM
    assert define("FD_TRACE_BLOCKS") == fd.TRACE_BLOCKS
    assert define("FD_PHASES") == len(fd.PHASES)
    assert re.search(rf"__global__ void __launch_bounds__\(kThreads\) "
                     rf"{fd.KERNEL_NAME}\(", src)


def cluster_model(q, k, v, length, window=None):
    """The kernel's arithmetic in fp32: each block of a (kv head, slot)
    cluster runs an online softmax over the live tiles of its range (a
    tile with no live cell is skipped; a dead cell's row is zero, never
    read: NaN there must not show), and the blocks' partials (m, l, acc)
    combine in rank order."""
    b, _, hq, dh = q.shape
    s_max, hk = k.shape[1], k.shape[2]
    g = hq // hk
    mask = decode_valid_mask(length, s_max, window)
    out = torch.zeros((b, 1, hq, dh), dtype=torch.float32)
    for bi in range(b):
        for h in range(hk):
            qg = q[bi, 0, h * g:(h + 1) * g].float()
            parts = []
            for start, end in fd.cluster_ranges(int(length[bi]), s_max):
                m = torch.full((g,), -1e30)
                l = torch.zeros(g)
                acc = torch.zeros((g, dh))
                for t in range(start, end, fd.TILE_CELLS):
                    cells = torch.arange(t, min(t + fd.TILE_CELLS, s_max))
                    lv = mask[bi, cells]
                    if not lv.any():
                        continue
                    kk = torch.where(lv[:, None], k[bi, cells, h].float(), 0)
                    vv = torch.where(lv[:, None], v[bi, cells, h].float(), 0)
                    s = torch.where(lv, (qg @ kk.T) * dh ** -0.5, -1e30)
                    mn = torch.maximum(m, s.amax(-1))
                    p = torch.where(lv, torch.exp(s - mn[:, None]), 0.0)
                    corr = torch.exp(m - mn)
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[:, None] + p @ vv
                    m = mn
                parts.append((m, l, acc))
            m_all = torch.stack([p[0] for p in parts]).amax(0)
            l_all = torch.zeros(g)
            a = torch.zeros((g, dh))
            for m, l, acc in parts:
                e = torch.exp(m - m_all)
                l_all = l_all + l * e
                a = a + acc * e[:, None]
            out[bi, 0, h * g:(h + 1) * g] = (
                a / l_all.clamp_min(1e-30)[:, None])
    return out


# (B, S_max, Hk, G, dh, lengths, window): the serving lengths, prefixes
# shorter than a cluster of tiles, lengths ending mid-tile and mid-range,
# and SWA rings before and after they wrap
MODEL_CASES = [
    (4, 512, 2, 4, 16, [0, 1, 300, 512], None),
    (2, 8, 1, 5, 8, [7, 3], None),
    (2, 40, 2, 1, 24, [39, 40], None),
    (3, 1000, 1, 2, 16, [999, 517, 33], None),
    (2, 256, 2, 3, 8, [255, 300], 100),
    (2, 64, 1, 2, 16, [64 + 5, 64 + 40], 24),
]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_cluster_model_matches_plain_and_jax(case):
    b, s_max, hk, g, dh, lengths, window = case
    rng = np.random.default_rng(s_max + g)
    q = rng.normal(size=(b, 1, hk * g, dh)).astype(np.float32)
    k = rng.normal(size=(b, s_max, hk, dh)).astype(np.float32)
    v = rng.normal(size=(b, s_max, hk, dh)).astype(np.float32)
    length = torch.tensor(lengths, dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = fd.flash_decode_torch(tq, tk, tv, length, window=window)
    # dead cells poisoned: the model (like the kernel) never uses them
    dead = ~decode_valid_mask(length, s_max, window)
    pk, pv = tk.clone(), tv.clone()
    pk[dead], pv[dead] = float("nan"), float("nan")
    got = cluster_model(tq, pk, pv, length, window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    cache = jattn.KVCache(jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(lengths, jnp.int32))
    ref = jattn.decode_attention(jnp.asarray(q), cache, window=window,
                                 impl="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if 0 in lengths:
        assert torch.equal(got[lengths.index(0)], torch.zeros_like(got[0]))
