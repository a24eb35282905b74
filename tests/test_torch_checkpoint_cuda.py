"""The port's checkpointing on the card: the delta chain's int8 encode
(kernel ``pseudograd_encode_hist``) and its apply (kernel
``decode_add``) against the CPU's plain versions, chains crossing
devices, and the snapshotter under in-place writes. Needs a CUDA device
and nvcc (skipped without a device); imports no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_checkpoint_cuda.py

Tolerances: the apply is one fp32 add of a looked-up value, so the
kernel equals the plain add bit for bit, and a chain replays bitwise on
either device. The card's and the CPU's codes of the same delta are
equal but for elements within 1e-4 bucket widths of a bucket edge,
which may move by one (the two devices' mean/std reductions may round
lo and width apart); codebooks agree within rtol 1e-4 and atol 1e-6
bucket widths (the kernel's fixed-point bucket sums are held to 1e-4 of
the bucket's sum of |x| in the codec's card tests). Launch counts are exact: one
encode and one apply per float leaf per int8 delta, one apply per float
leaf per replayed delta.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpointing import (AsyncSnapshotter, ChunkStore,
                                       DeltaCheckpointer, DeltaConfig)
from repro_torch.checkpointing import delta
from repro_torch.kernels import int8_quant as iq
from repro_torch.kernels import ref as qref

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


def _trees(n=40_000, steps=3, seed=0):
    """Checkpoint-like trees on the host: bf16 params, fp32 anchor and
    momentum, an int32 counter; each step moves by N(0, 1e-3)."""
    rng = np.random.default_rng(seed)
    anchor = rng.normal(size=n).astype(np.float32)
    mom = np.zeros(n, np.float32)
    out = []
    for t in range(steps):
        a = torch.from_numpy(anchor.copy())
        out.append({"params": {"w": a.to(torch.bfloat16),
                               "b": torch.from_numpy(anchor[:77].copy())},
                    "anchor": {"w": a, "b": a[:77].clone()},
                    "outer_momentum": {"w": torch.from_numpy(mom.copy()),
                                       "b": torch.zeros(77)},
                    "step": torch.tensor(t, dtype=torch.int32)})
        upd = (rng.normal(size=n) * 1e-3).astype(np.float32)
        anchor = anchor + upd
        mom = 0.9 * mom + upd
    return out


def _write(root, trees, device, codec="int8"):
    store = ChunkStore(root, chunk_bytes=1 << 14)
    w = DeltaCheckpointer(store, DeltaConfig(base_every=8, codec=codec),
                          device=device)
    manifests = [w.save(t, tree, {"outer_step": t})
                 for t, tree in enumerate(trees)]
    return store, w, manifests


def _equal(got, want):
    from repro_torch.checkpointing import checkpoint as ck
    g, w = ck._flatten(got), ck._flatten(want)
    assert list(g) == list(w)
    for k in w:
        assert torch.equal(g[k].cpu(), w[k].cpu()), k


def _codes(store, entry):
    d = entry["delta"]
    return torch.frombuffer(store.read_bytes(
        [c["id"] for c in d["codes_chunks"]]), dtype=torch.uint8).long()


def _book(store, entry):
    return torch.frombuffer(bytearray(store.get(entry["delta"]["codebook_id"])),
                            dtype=torch.float32)


@needs_cuda
def test_delta_writer_card_vs_cpu(tmp_path):
    trees = _trees()
    sg, _, mg = _write(tmp_path / "gpu", trees, "cuda")
    sc, _, mc = _write(tmp_path / "cpu", trees, "cpu")
    assert mg[0]["keys"] == mc[0]["keys"]          # the base is exact
    for key, entry in mc[1]["keys"].items():
        if "delta" not in entry:
            assert mg[1]["keys"][key] == entry
            continue
        cg, cc = _codes(sg, mg[1]["keys"][key]), _codes(sc, entry)
        diff = torch.nonzero(cg != cc).flatten()
        if diff.numel():
            assert ((cg[diff] - cc[diff]).abs() == 1).all()
        bg, bc = _book(sg, mg[1]["keys"][key]), _book(sc, entry)
        width = (bc[-1] - bc[0]).abs() / 255 + 1e-30
        torch.testing.assert_close(bg, bc, rtol=1e-4,
                                   atol=float(1e-6 * width))


@needs_cuda
def test_delta_codes_flip_only_at_edges(tmp_path):
    trees = _trees(n=200_003, steps=2, seed=3)
    sg, _, mg = _write(tmp_path / "gpu", trees, "cuda")
    sc, _, mc = _write(tmp_path / "cpu", trees, "cpu")
    x = (trees[1]["anchor"]["w"] - trees[0]["anchor"]["w"])[None]
    lo, width = qref.quant_params(x)
    cg = _codes(sg, mg[1]["keys"]["anchor::w"])
    cc = _codes(sc, mc[1]["keys"]["anchor::w"])
    diff = torch.nonzero(cg != cc).flatten()
    pos = (x[0, diff].double() - lo.double()) / width.double()
    assert ((pos - pos.round()).abs() < 1e-4).all()
    assert ((cg[diff] - cc[diff]).abs() == 1).all()


@needs_cuda
@pytest.mark.parametrize("book_size", [256, 16])
def test_apply_kernel_bitwise(book_size):
    gen = torch.Generator().manual_seed(book_size)
    n = 1_000_003
    ref = torch.randn(n, generator=gen)
    codes = torch.randint(0, book_size, (n,), generator=gen,
                          dtype=torch.uint8)
    book = torch.randn(book_size, generator=gen) * 1e-3
    want = ref.clone()
    delta._apply_delta(want, codes, book)          # plain, on the CPU
    got = ref.cuda()
    before = iq.decode_add.launches
    delta._apply_delta(got, codes.cuda(), book.cuda())
    assert iq.decode_add.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, ref + book[codes.long()])


@needs_cuda
@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_chains_replay_across_devices(tmp_path, codec):
    trees = _trees(n=30_001, steps=4, seed=5)
    like = trees[-1]
    for wdev, rdev in (("cuda", "cpu"), ("cpu", "cuda")):
        store, w, _ = _write(tmp_path / f"{wdev}_{codec}", trees, wdev,
                             codec)
        got, meta = delta.restore(store, like, device=rdev)
        assert meta == {"outer_step": 3}
        _equal(got, w.reference(like))


@needs_cuda
@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_launch_counts_exact(tmp_path, codec):
    trees = _trees(n=20_000, steps=3, seed=7)
    n_float = 6                     # params, anchor, momentum: w and b
    c0 = {n: getattr(iq, n).launches for n in
          ("pseudograd_encode_hist", "decode_add", "encode_hist", "decode")}
    store, _, _ = _write(tmp_path / "w", trees, "cuda", codec)
    c1 = {n: getattr(iq, n).launches for n in c0}
    deltas = 2
    assert c1["pseudograd_encode_hist"] - c0["pseudograd_encode_hist"] == \
        (n_float * deltas if codec == "int8" else 0)
    assert c1["decode_add"] - c0["decode_add"] == n_float * deltas
    assert c1["encode_hist"] == c0["encode_hist"]
    assert c1["decode"] == c0["decode"]
    delta.restore(store, trees[-1], device="cuda")
    assert iq.decode_add.launches - c1["decode_add"] == n_float * deltas


@needs_cuda
def test_snapshot_stable_under_in_place_writes_on_a_busy_stream():
    """``submit`` queues its copies behind the busy stream's work; the
    in-place write that follows on the same stream must not reach the
    persisted snapshot."""
    seen = {}
    snap = AsyncSnapshotter(lambda step, tree, meta: seen.setdefault(
        step, {k: v.clone() for k, v in tree.items()}))
    a = torch.randn(4096, 4096, device="cuda")
    x = torch.randn(1 << 22, device="cuda")
    want = x.cpu()
    for step in range(3):
        for _ in range(4):
            a = a @ a / 64.0                       # keep the stream busy
        snap.submit(step, {"x": x, "a_sum": a.sum()})
        x.add_(1.0)                                # in place, same stream
        snap.flush()
        assert torch.equal(seen[step]["x"], want)
        want.add_(1.0)                             # the same fp32 adds
    assert snap._slots[0].tree["x"].is_pinned()
    snap.close()
