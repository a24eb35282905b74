"""repro_torch's checkpointing (flat checkpoints, the chunk store, delta
chains, the snapshotter) against repro's on the same numpy-seeded trees,
on the CPU.

Tolerances: flat checkpoints, store manifests, chunk ids and blobs are
byte-identical across the two packages (a bf16 leaf is its raw uint16
bits in both); base manifests of a delta chain are identical. A delta's
codes are equal given the same lo and width; lo and width come from two
frameworks' mean/std reductions, so a code may move by one, and only for
an element within 1e-4 bucket widths of an edge: every code chunk free
of such a flip has the same id in both packages. Codebooks are allclose
(rtol 1e-5, atol 1e-6 bucket widths) in buckets no flip touched, as in
``test_torch_int8_quant.py``. Later steps' reconstructions stay within
one bucket width of the reference's. A chain written by either package
replays in the other bitwise equal to its writer's reconstruction (the
apply is one fp32 add, the same bits in numpy and PyTorch), with no
``DeltaChainError``.
"""
import hashlib
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as jck
from repro.checkpointing import delta as jdelta
from repro.checkpointing.delta import DeltaCheckpointer as JWriter
from repro.checkpointing.delta import DeltaConfig as JDeltaConfig
from repro.checkpointing.store import ChunkStore as JStore
from repro_torch.checkpointing import (AsyncSnapshotter, ChunkStore,
                                       DeltaChainError, DeltaCheckpointer,
                                       DeltaConfig)
from repro_torch.checkpointing import checkpoint as tck
from repro_torch.checkpointing import delta as tdelta
from repro_torch.checkpointing import store as tstore
from repro_torch.kernels import ref as qref

torch.set_num_threads(2)


def _np_tree(seed=0, n=5_000):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(n,)).astype(np.float32),
                       "e": rng.normal(size=(17, 33)).astype(np.float32),
                       "h": rng.normal(size=(64,)).astype(
                           ml_dtypes.bfloat16)},
            "ids": rng.integers(-9, 9, size=(11,)).astype(np.int32),
            "step": np.int32(seed)}


def _t(tree):
    """The port's copy of a numpy tree."""
    return tck.unflatten_like(tree, {k: tck.as_tensor(v) for k, v in
                                     tck._flatten(tree).items()})


def _np(x):
    """A port leaf as numpy (bf16 through ml_dtypes) for comparison."""
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def _assert_bitwise(got_port, want_np):
    g, w = tck._flatten(got_port), jck._flatten(want_np)
    assert list(g) == list(w)
    for k in w:
        a, b = _np(tck.as_tensor(g[k])), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _chain_trees(seed=7, n=24_000, steps=4, bf16=True):
    """Trainer-like trees (params, anchor, momentum, a counter) moving
    by small heavy-tailed updates, as the reference's chain tests."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    mom = np.zeros(n, np.float32)
    trees = []
    for t in range(steps):
        trees.append({"params": {"w": p.astype(ml_dtypes.bfloat16)
                                 if bf16 else p.copy(),
                                 "b": p[:50].copy()},
                      "anchor": {"w": p.copy(), "b": p[:50].copy()},
                      "outer_momentum": {"w": mom.copy(),
                                         "b": mom[:50].copy()},
                      "step": np.int32(t)})
        upd = rng.normal(size=n).astype(np.float32) * 1e-3
        upd += ((rng.random(n) < 0.05)
                * rng.normal(size=n)).astype(np.float32) * 0.03
        p = p + upd
        mom = (0.9 * mom + upd).astype(np.float32)
    return trees


# -- flat checkpoints ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_flat_roundtrip_exact(tmp_path, dtype):
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(7, 9, generator=gen) * 100).to(dtype)
    tree = {"a": {"x": x, "s": torch.tensor(3, dtype=torch.int32)},
            "b": {"0": x[0].clone(), "1": x[1].clone()}}
    tck.save(tmp_path, 5, tree, {"m": 1})
    assert tck.latest_step(tmp_path) == 5
    got, meta = tck.restore(tmp_path, tree)
    assert meta == {"m": 1}
    for a, b in zip(tck._flatten(got).values(),
                    tck._flatten(tree).values()):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_flat_checkpoint_crosses_packages(tmp_path, writer):
    tree = _np_tree(3)
    if writer == "repro":
        jck.save(tmp_path, 2, tree, {"outer_step": 1})
        got, meta = tck.restore(tmp_path, _t(tree))
        _assert_bitwise(got, tree)
    else:
        tck.save(tmp_path, 2, _t(tree), {"outer_step": 1})
        got, meta = jck.restore(tmp_path, tree)
        _assert_bitwise(_t(got), tree)
    assert meta == {"outer_step": 1}


def test_flat_manifest_fields_match_repro(tmp_path):
    import json
    tree = _np_tree(4)
    jck.save(tmp_path / "j", 1, tree, {"x": 1})
    tck.save(tmp_path / "t", 1, _t(tree), {"x": 1})
    mj = json.loads((tmp_path / "j/step_00000001/manifest.json").read_text())
    mt = json.loads((tmp_path / "t/step_00000001/manifest.json").read_text())
    assert mj["keys"] == mt["keys"] and mj["meta"] == mt["meta"]
    for info in mj["keys"].values():
        a = (tmp_path / "j/step_00000001/arrays" / info["file"]).read_bytes()
        b = (tmp_path / "t/step_00000001/arrays" / info["file"]).read_bytes()
        assert a == b


# -- the chunk store -----------------------------------------------------------


def _blobs(root):
    return {p.name: p.read_bytes() for p in (root / "chunks").rglob("*")
            if p.is_file() and not p.name.startswith(".")}


@pytest.mark.parametrize("chunk_bytes", [1 << 10, 1 << 20])
def test_save_tree_manifests_and_blobs_match_repro(tmp_path, chunk_bytes):
    js, ts = (JStore(tmp_path / "j", chunk_bytes=chunk_bytes),
              ChunkStore(tmp_path / "t", chunk_bytes=chunk_bytes))
    for step, seed in ((1, 0), (2, 1)):
        tree = _np_tree(seed)
        tree["anchor"] = tree["params"]          # intra-step dedup
        mj = js.save_tree(step, tree, {"s": step})
        mt = ts.save_tree(step, _t(tree), {"s": step})
        assert mj == mt
    assert _blobs(tmp_path / "j") == _blobs(tmp_path / "t")
    assert js.inventory() == ts.inventory()
    got, _ = ts.restore_tree(_t(tree), step=2)
    _assert_bitwise(got, tree)


def test_thread_pool_put_is_byte_identical_to_serial(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    big = rng.normal(size=150_000).astype(np.float32)
    big[20_000:60_000] = 0.0                     # repeated chunks in a leaf
    tree = {"a": big, "b": big.copy(), "c": rng.normal(size=3).astype(
        np.float32)}
    par = ChunkStore(tmp_path / "par", chunk_bytes=1 << 12)
    m_par = par.save_tree(0, _t(tree))
    monkeypatch.setattr(tstore, "pmap", lambda fn, xs: [fn(x) for x in xs])
    ser = ChunkStore(tmp_path / "ser", chunk_bytes=1 << 12)
    m_ser = ser.save_tree(0, _t(tree))
    assert m_par == m_ser
    assert m_par["stats"]["dedup_chunks"] > len(m_par["keys"]["b"]["chunks"])
    assert _blobs(tmp_path / "par") == _blobs(tmp_path / "ser")
    m_j = JStore(tmp_path / "j", chunk_bytes=1 << 12).save_tree(0, tree)
    assert m_j == m_par
    for entry in m_par["keys"].values():
        for c in entry["chunks"]:
            data = par.get(c["id"])
            assert hashlib.sha256(data).hexdigest() == c["id"]


@pytest.mark.parametrize("keep", [[5], [3, 4], [0], []])
def test_gc_pins_and_retire_keep_what_repro_keeps(tmp_path, keep):
    """The same chains, pins and tombstones in both stores: gc keeps the
    same steps (whole delta chains behind a kept step), the same pinned
    steps, and leaves every kept step restorable."""
    trees = _chain_trees(n=3_000, steps=6)
    stores = {}
    for name in ("j", "t"):
        store = (JStore if name == "j" else ChunkStore)(
            tmp_path / name, chunk_bytes=1 << 12)
        w = (JWriter(store, JDeltaConfig(base_every=3)) if name == "j"
             else DeltaCheckpointer(store, DeltaConfig(base_every=3),
                                    device="cpu"))
        for t, tree in enumerate(trees):
            w.save(t, tree if name == "j" else _t(tree))
        stores[name] = store
    out = {}
    for name, store in stores.items():
        token = store.pin_chain(2)               # a peer is serving 0..2
        store.retire_step(1)
        stats = store.gc(keep_steps=keep)
        kept = store.steps()
        store.unpin(token)
        stats2 = store.gc(keep_steps=keep)
        out[name] = (stats["manifests"], stats["pinned"], kept,
                     stats2["manifests"], store.steps(),
                     sorted(store.retired_steps()))
        for s in store.steps():
            for d in store.missing(store.load_manifest(s)):
                raise AssertionError(f"{name}: kept step {s} lacks {d}")
    assert out["j"] == out["t"]


def test_store_engine_pins_hold_the_same_chunks(tmp_path):
    js, ts = JStore(tmp_path / "j"), ChunkStore(tmp_path / "t")
    for s in range(3):
        js.save_tree(s, _np_tree(s))
        ts.save_tree(s, _t(_np_tree(s)))
    for store in (js, ts):
        store.pin_ids(store.inventory()[:3])
        store.gc(keep_steps=[2])
    assert js.steps() == ts.steps() == [2]
    assert js.inventory() == ts.inventory()
    assert js.inventory_digest() == ts.inventory_digest()


# -- delta chains --------------------------------------------------------------


def _codes(store, entry, codec):
    d = entry["delta"]
    raw = np.frombuffer(b"".join(store.get(c["id"])
                                 for c in d["codes_chunks"]), np.uint8)
    return jdelta._unpack4(raw, d["numel"]) if codec == "int4" else raw


def _check_first_delta(js, ts, trees, codec):
    nb = 256 if codec == "int8" else 16
    mj, mt = js.load_manifest(1), ts.load_manifest(1)
    for key, ej in mj["keys"].items():
        et = mt["keys"][key]
        if "delta" not in ej:
            assert ej == et
            continue
        cj, ct = _codes(js, ej, codec), _codes(ts, et, codec)
        x = (jck._flatten(trees[1])[key].astype(np.float32)
             - jck._flatten(trees[0])[key].astype(np.float32)).reshape(-1)
        mu, sigma = x.mean(dtype=np.float64), x.std(dtype=np.float64)
        lo, width = mu - 6 * sigma, 12 * sigma / nb
        diff = np.nonzero(cj != ct)[0]
        assert np.all(np.abs(cj[diff].astype(int) - ct[diff]) == 1)
        pos = (x[diff] - lo) / width
        assert np.all(np.abs(pos - np.round(pos)) < 1e-4), key
        per = js.chunk_bytes * (2 if codec == "int4" else 1)
        flipped = set((diff // per).tolist())
        for i, (a, b) in enumerate(zip(ej["delta"]["codes_chunks"],
                                       et["delta"]["codes_chunks"])):
            if i not in flipped:
                assert a == b, (key, i)
        bj = np.frombuffer(js.get(ej["delta"]["codebook_id"]), np.float32)
        bt = np.frombuffer(ts.get(et["delta"]["codebook_id"]), np.float32)
        touched = np.zeros(nb, bool)
        touched[cj[diff]] = touched[ct[diff]] = True
        np.testing.assert_allclose(bt[~touched], bj[~touched], rtol=1e-5,
                                   atol=1e-6 * width)


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_delta_writer_matches_repro(tmp_path, codec):
    trees = _chain_trees(n=24_001 if codec == "int4" else 24_000)
    js = JStore(tmp_path / "j", chunk_bytes=1 << 14)
    ts = ChunkStore(tmp_path / "t", chunk_bytes=1 << 14)
    jw = JWriter(js, JDeltaConfig(base_every=16, codec=codec))
    tw = DeltaCheckpointer(ts, DeltaConfig(base_every=16, codec=codec),
                           device="cpu")
    for t, tree in enumerate(trees):
        mj = jw.save(t, tree, {"outer_step": t})
        mt = tw.save(t, _t(tree), {"outer_step": t})
        assert mj["kind"] == mt["kind"] == ("base" if t == 0 else "delta")
        if t == 0:
            assert mj == mt
        else:
            assert mj["stats"]["codes_bytes"] == mt["stats"]["codes_bytes"]
            assert mj["stats"]["logical_bytes"] == \
                mt["stats"]["logical_bytes"]
            assert (mj["base_step"], mj["prev_step"]) == \
                (mt["base_step"], mt["prev_step"])
    _check_first_delta(js, ts, trees, codec)
    like = trees[-1]
    rj, rt = jw.reference(like), tw.reference(_t(like))
    nb = 256 if codec == "int8" else 16
    for key, a in jck._flatten(rj).items():
        b = tck._flatten(rt)[key]
        if a.dtype.kind == "i":
            continue
        x = (jck._flatten(trees[-1])[key].astype(np.float32)
             - jck._flatten(trees[-2])[key].astype(np.float32))
        width = 12 * x.std() / nb
        err = np.abs(_np(b).astype(np.float32) - a.astype(np.float32))
        assert err.max() <= width + 1e-6, key


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("writer", ["port", "repro"])
def test_delta_chain_restores_across_packages(tmp_path, codec, writer):
    """The gate of the port's checkpoints: a chain either package wrote
    replays in the other, every ``ref_sha`` verified, bitwise equal to
    its writer's reconstruction."""
    trees = _chain_trees(seed=11, n=9_001, steps=4)
    like = trees[-1]
    if writer == "port":
        store = ChunkStore(tmp_path, chunk_bytes=1 << 12)
        w = DeltaCheckpointer(store, DeltaConfig(base_every=8, codec=codec),
                              device="cpu")
        for t, tree in enumerate(trees):
            w.save(t, _t(tree), {"outer_step": t})
        want = w.reference(_t(like))
        for step in (2, 3):
            got, meta = jdelta.restore(JStore(tmp_path), like, step=step)
            assert meta == {"outer_step": step}
        _assert_bitwise(want, got)
    else:
        store = JStore(tmp_path, chunk_bytes=1 << 12)
        w = JWriter(store, JDeltaConfig(base_every=8, codec=codec))
        for t, tree in enumerate(trees):
            w.save(t, tree, {"outer_step": t})
        got, meta = tdelta.restore(ChunkStore(tmp_path), _t(like),
                                   device="cpu")
        assert meta == {"outer_step": 3}
        _assert_bitwise(got, w.reference(like))


def test_delta_chain_8x_wire_reduction_and_bit_exact(tmp_path):
    trees = _chain_trees(seed=7, n=24_000, steps=6, bf16=False)
    store = ChunkStore(tmp_path, chunk_bytes=1 << 14)
    w = DeltaCheckpointer(store, DeltaConfig(base_every=16), device="cpu")
    ms = [w.save(t, _t(tree), {"outer_step": t})
          for t, tree in enumerate(trees)]
    like = _t(trees[-1])
    got, _ = tdelta.restore(store, like, device="cpu")
    ref = w.reference(like)
    for k in ("params", "anchor", "outer_momentum"):
        assert torch.equal(got[k]["w"], ref[k]["w"])
    err = (got["params"]["w"] - like["params"]["w"]).abs()
    assert torch.quantile(err, 0.99) < 2e-3 and err.max() < 0.1
    flat_fp32 = sum(tree.numel() * 4 for tree in (
        like["params"]["w"], like["anchor"]["w"],
        like["outer_momentum"]["w"]))
    assert flat_fp32 / ms[-1]["stats"]["new_bytes"] >= 8.0


def test_delta_rebases_on_schedule_and_structure_change(tmp_path):
    store = ChunkStore(tmp_path)
    w = DeltaCheckpointer(store, DeltaConfig(base_every=3), device="cpu")
    t0 = {"w": torch.randn(100, generator=torch.Generator().manual_seed(0))}
    kinds = [w.save(s, t0)["kind"] for s in range(6)]
    assert kinds == ["base", "delta", "delta", "base", "delta", "delta"]
    assert w.save(6, {"w": torch.zeros(50)})["kind"] == "base"


def test_delta_tampered_chain_and_failed_save(tmp_path, monkeypatch):
    trees = [_t(t) for t in _chain_trees(n=2_000, steps=4)]
    store = ChunkStore(tmp_path)
    w = DeltaCheckpointer(store, DeltaConfig(base_every=8), device="cpu")
    w.save(0, trees[0])
    w.save(1, trees[1])
    real_write = ChunkStore.write_manifest
    monkeypatch.setattr(ChunkStore, "write_manifest", lambda self, m: (
        _ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(OSError):
        w.save(2, trees[2])
    monkeypatch.setattr(ChunkStore, "write_manifest", real_write)
    assert w.save(3, trees[3])["kind"] == "base"   # re-anchored
    got, _ = tdelta.restore(store, trees[3], step=3, device="cpu")
    assert torch.equal(got["params"]["w"],
                       w.reference(trees[3])["params"]["w"])
    got, _ = tdelta.restore(store, trees[1], step=1, device="cpu")
    m = store.load_manifest(1)
    m["ref_sha"]["params::w"] = "0" * 64
    store.write_manifest(m)
    with pytest.raises(DeltaChainError):
        tdelta.restore(store, trees[1], step=1, device="cpu")
    store.gc(keep_steps=[3])
    assert store.steps() == [3]


def test_delta_encode_is_the_codec_on_one_row():
    """The writer's int8 encode is ``ops.quantize_pseudograd`` on a
    (1, numel) row: its codes are the plain quantizer's of theta - ref."""
    gen = torch.Generator().manual_seed(3)
    ref = torch.randn(5_000, generator=gen)
    new = ref + torch.randn(5_000, generator=gen) * 1e-3
    codes, book, wire = tdelta._encode(new, ref, DeltaConfig())
    q = qref.quantize((new - ref)[None])
    assert torch.equal(codes, q.codes[0])
    assert wire.tobytes() == q.codes.numpy().tobytes()
    torch.testing.assert_close(book, q.codebook[0], rtol=0, atol=0)


# -- the snapshotter -----------------------------------------------------------


def test_snapshotter_fifo_and_backpressure():
    written, gate = [], threading.Event()

    def slow_write(step, tree, meta):
        gate.wait(5)
        written.append((step, float(tree["x"][0]), meta["m"]))

    snap = AsyncSnapshotter(slow_write, buffers=2)
    snap.submit(0, {"x": torch.full((8,), 0.0)}, {"m": 0})
    snap.submit(1, {"x": torch.full((8,), 1.0)}, {"m": 1})
    third_done = threading.Event()

    def third():
        snap.submit(2, {"x": torch.full((8,), 2.0)}, {"m": 2})
        third_done.set()

    threading.Thread(target=third, daemon=True).start()
    assert not third_done.wait(0.3)            # both buffers in flight
    gate.set()
    assert third_done.wait(5)
    snap.submit(3, {"x": torch.full((8,), 3.0)}, {"m": 3})
    snap.flush(timeout=10)
    assert [w[0] for w in written] == [0, 1, 2, 3]
    assert [w[1] for w in written] == [0.0, 1.0, 2.0, 3.0]
    assert snap.stats["blocked_waits"] >= 1
    snap.close()


def test_snapshotter_copy_is_stable_under_in_place_writes():
    seen = []
    snap = AsyncSnapshotter(lambda s, t, m: seen.append(t["x"].clone()))
    x = torch.ones(16)
    for s in range(4):
        snap.submit(s, {"x": x})
        x.mul_(-2.0)                             # in place, as the trainer
    snap.flush(timeout=10)
    assert [float(v[0]) for v in seen] == [1.0, -2.0, 4.0, -8.0]
    snap.close()


def test_snapshotter_surfaces_writer_and_task_errors():
    def bad_write(step, tree, meta):
        raise RuntimeError("disk full")

    snap = AsyncSnapshotter(bad_write)
    snap.submit(0, {"x": torch.zeros(4)})
    with pytest.raises(RuntimeError, match="disk full"):
        snap.flush(timeout=10)
    snap2 = AsyncSnapshotter(lambda *a: None)
    snap2.submit_task(lambda: (_ for _ in ()).throw(RuntimeError("gc")))
    with pytest.raises(RuntimeError, match="gc"):
        for _ in range(100):
            snap2.flush()
            time.sleep(0.01)
    gate = threading.Event()
    snap3 = AsyncSnapshotter(lambda s, t, m: gate.wait(10))
    snap3.submit(0, {"x": torch.zeros(4)})
    with pytest.raises(TimeoutError):
        snap3.flush(timeout=0.2)
    gate.set()
    snap3.close()


def test_snapshotter_tasks_run_behind_writes_and_on_persist_order():
    order, seen = [], []

    def slow_write(step, tree, meta):
        time.sleep(0.05)
        order.append(("write", step))
        return {"step": step}

    snap = AsyncSnapshotter(slow_write, buffers=2,
                            on_persist=lambda s, m: seen.append(m["step"]))
    snap.submit(1, {"w": torch.zeros(4)})
    snap.submit_task(lambda: order.append(("task", 1)))
    snap.submit(2, {"w": torch.ones(4)})
    snap.flush()
    snap.close()
    assert order == [("write", 1), ("task", 1), ("write", 2)]
    assert seen == [1, 2] and snap.stats["tasks"] == 1
