"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and nvcc; imports nothing of JAX or of ``repro``.
Phases, each of which raises on failure (nothing is caught):

1. environment: the card (nvidia-smi name and power limit), torch, CUDA
   and nvcc versions;
2. build: every CUDA kernel of the ported paths, from the sources in
   this checkout (``src/repro_torch/kernels/csrc``), one nvcc per source;
3. kernels: each kernel against its plain PyTorch version on the card,
   at its main path's shapes (flash-decode at the serving shape, the
   four int8 codec kernels at the training ring's 2 x 378,535,936 fp32
   hop), with its time, its plain version's time, the time of the
   nearest PyTorch call (a yardstick the port never calls) and the least
   time the card could take;
4. reduced models: the reduced INTELLECT-1 served and trained on the
   card must agree with the same model on the CPU;
5. main path, serving: ``repro_torch.launch.serve`` serves INTELLECT-1
   at full width and depth (random weights from a seed) with the
   continuous and the wave engine; every request must finish with
   in-vocabulary tokens and flash-decode must launch once per layer per
   decode step;
6. main path, training: ``repro_torch.launch.train`` trains
   internlm2-1.8b at full width, depth cut to 6, two DiLoCo workers, the
   int8 ring, two outer steps; losses must be finite and every codec
   kernel must launch exactly as often per outer sync as the ring's
   formula says; one outer sync is then replayed from the same inputs
   with the plain codec on the card and the anchors must agree.

The last three lines are the kernels (JSON), the card (name, power
limit) and the result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
SERVE_ARGS = ["--arch", "intellect-1", "--slots", "4", "--requests", "8",
              "--prompt-len", "64", "--max-new", "32", "--max-len", "512"]
TRAIN_ARGS = ["--arch", "internlm2-1.8b", "--n-layers", "6", "--workers", "2",
              "--max-workers", "2", "--quant", "int8", "--seq-len", "512",
              "--batch-per-worker", "4", "--inner-steps", "4",
              "--outer-steps", "2"]
CODEC = ("pseudograd_encode_hist", "encode_hist", "decode_add", "decode")
L2_FLUSH_BYTES = 256 << 20       # > the 50 MB L2: each timed call starts cold
SPIN_CYCLES = 2_000_000          # ~1 ms at the H100's 1.98 GHz boost clock


def log(msg: str) -> None:
    print(msg, flush=True)


def environment() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: chip_smoke needs the GPU")
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"env: gpu=[{smi}] torch={torch.__version__} "
        f"cuda={torch.version.cuda} python={sys.version.split()[0]} "
        f"nvcc=[{nvcc}]")
    return smi


def build() -> None:
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        libs = list(pool.map(_build.build, names))
    log(f"build: {names} in {time.perf_counter() - t0:.1f}s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {lib.stem}: {line.strip()}")


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, each timed
    with CUDA events after a write of more than the L2 cache. A device
    spin of about a millisecond before the start event keeps the card
    busy while the host enqueues ``fn``, so the host's launch overhead
    stays out of the measurement."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def flash_decode_inputs(b, s_max, hk, g, dh, dtype, lengths, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return (randn(b, 1, hk * g, dh), randn(b, s_max, hk, dh),
            randn(b, s_max, hk, dh),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def flash_decode_bound(q, k, length, window) -> tuple[float, str]:
    """Least time for this call: the live K/V cells, q and the output
    moved once, against the QK and PV products done once."""
    from repro_torch.models.attention import decode_valid_mask
    b, _, hq, dh = q.shape
    hk = k.shape[2]
    live = int(decode_valid_mask(length, k.shape[1], window).sum())
    size = q.element_size()
    nbytes = (2 * live * hk * dh * size + 2 * q.numel() * size
              + length.numel() * 4)
    flops = 4 * live * hq * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash_decode() -> dict:
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.attention import decode_valid_mask
    cases = [  # (label, B, S_max, Hk, G, dh, dtype, lengths, window)
        ("serve-bf16", 4, 512, 8, 4, 128, torch.bfloat16, [0, 1, 300, 512],
         None),
        ("serve-fp32", 4, 512, 8, 4, 128, torch.float32, [0, 1, 300, 512],
         None),
        ("swa-wrap-bf16", 11, 256, 8, 4, 128, torch.bfloat16,
         list(range(255, 266)), 256),
    ]
    result = None
    for i, (label, b, s, hk, g, dh, dtype, lengths, window) in \
            enumerate(cases):
        q, k, v, length = flash_decode_inputs(b, s, hk, g, dh, dtype,
                                              lengths, seed=i)
        out = fd.flash_decode(q, k, v, length, window=window)
        torch.cuda.synchronize()
        ref = fd.flash_decode_torch(q, k, v, length, window=window)
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out).all() or err > TOL[dtype]:
            raise AssertionError(f"flash_decode {label}: max |err| {err} "
                                 f"> {TOL[dtype]}")
        if lengths[0] == 0 and out[0].abs().max().item() != 0.0:
            raise AssertionError(f"flash_decode {label}: empty slot not 0")
        log(f"kernel flash_decode {label}: max|err|={err:.3g} "
            f"(tol {TOL[dtype]})")
        if label != "serve-bf16":
            continue
        valid = decode_valid_mask(length, s, window)[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=valid, enable_gqa=True)
        bound, bound_by = flash_decode_bound(q, k, length, window)
        result = {
            "name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:282",
            "launches": None, "max_abs_err": err,
            "ms": time_ms(lambda: fd.flash_decode(q, k, v, length)),
            "plain_ms": time_ms(
                lambda: fd.flash_decode_torch(q, k, v, length)),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": time_ms(library),
            "shape": {"B": b, "S_max": s, "Hk": hk, "G": g, "dh": dh,
                      "dtype": "bfloat16", "lengths": lengths},
        }
    return result


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def check_reduced_model() -> None:
    """The reduced INTELLECT-1 in fp32 on the card (flash-decode kernel)
    against the same weights on the CPU (its plain version)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import get_model
    cfg = get_config("intellect-1").reduced()
    cpu, gpu = get_model(cfg, "cpu"), get_model(cfg, "cuda")
    params = cpu.init(0)
    gparams = to_device(params, "cuda")
    shape = ShapeConfig("smoke", "decode", 64, 3)
    toks = torch.randint(2, cfg.vocab, (3, 16),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    plen = torch.tensor([16, 5, 11], dtype=torch.int32)
    lc, cc = cpu.prefill(params, {"tokens": toks, "prompt_len": plen},
                         cpu.init_cache(3, shape))
    lg, cg = gpu.prefill(gparams, {"tokens": toks.cuda(),
                                   "prompt_len": plen.cuda()},
                         gpu.init_cache(3, shape))
    worst = (lg.cpu() - lc).abs().max().item()
    tok = lc.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(6):
        lc, cc = cpu.decode(params, tok, cc)
        lg, cg = gpu.decode(gparams, tok.cuda(), cg)
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
        tok = lc.argmax(-1, keepdim=True).to(torch.int32)
    if worst > 1e-3:
        raise AssertionError(f"reduced model GPU vs CPU: max|err| {worst}")
    log(f"reduced intellect-1 fp32 GPU vs CPU: max|logit err|={worst:.3g}"
        " (tol 1e-3)")


def serve(engine: str, run: int) -> dict:
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch import serve as serve_mod
    argv = SERVE_ARGS + ["--engine", engine]
    torch.cuda.reset_peak_memory_stats()
    fd.flash_decode.launches = 0
    s = serve_mod.main(argv)
    launches = fd.flash_decode.launches
    torch.cuda.synchronize()
    if not all(s["done"]) or s["requests"] != 8:
        raise AssertionError(f"{engine}: not every request finished")
    toks = [t for o in s["outputs"] for t in o]
    if not toks or not all(0 <= t < s["padded_vocab"] for t in toks):
        raise AssertionError(f"{engine}: token outside the vocabulary")
    want = s["n_layers"] * s["decode_steps"]
    if launches != want:
        raise AssertionError(f"{engine}: flash_decode launched {launches} "
                             f"times, want {want} = layers x decode steps")
    log(f"main path {engine} run {run}: tok/s={s['tokens_per_s']:.1f} "
        f"p50={s['latency_p50_s'] * 1e3:.1f}ms "
        f"p95={s['latency_p95_s'] * 1e3:.1f}ms "
        f"decode_steps={s['decode_steps']} launches={launches} "
        f"tokens={s['tokens_out']} wall={s['wall_s']:.3f}s peak_mem="
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f}GiB")
    s["launches"] = launches
    torch.cuda.empty_cache()
    return s


def train_hop_shape() -> tuple[int, int]:
    """(rows, n) of the training ring's codec calls: one row per ring
    position, one bucket of ceil(ceil(numel / k) / buckets) elements."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_parser
    a = build_parser().parse_args(TRAIN_ARGS)
    cfg = dataclasses.replace(get_config(a.arch), n_layers=a.n_layers)
    chunk = -(-cfg.param_count() // a.max_workers)
    return a.max_workers, -(-chunk // a.sync_buckets)


def check_hist(label, x, lo, width, got, want, again) -> float:
    """Codes and counts exact; a second call bitwise equal; sums within
    1e-4 of each bucket's sum of |x| of the plain version's (which adds
    in fp64; the kernel adds in fp32, at most a few thousand terms in a
    row); codebooks within 1e-4 of the bucket's mean |x| (+1e-6 widths).
    Returns the largest codebook difference."""
    from repro_torch.kernels import ref
    codes, sums, counts = got
    wc, ws, wn = want
    if not torch.equal(codes, wc):
        raise AssertionError(f"{label}: codes differ from the plain version")
    if not torch.equal(counts, wn):
        raise AssertionError(f"{label}: counts differ from the plain version")
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: a second call differs")
    abs_sums = ref.bucket_stats(x.abs(), codes)[0]
    rel = ((sums - ws).abs() / abs_sums.clamp_min(1e-30)).max().item()
    log(f"  {label}: bucket sums, max |kernel - plain| / sum|x| = {rel:.3g}")
    if rel > 1e-4:
        raise AssertionError(f"{label}: sums off the plain version")
    cb = ref.make_codebook(sums, counts, lo, width)
    cb_plain = ref.make_codebook(ws, wn, lo, width)
    tol = 1e-4 * abs_sums / counts.clamp_min(1) + 1e-6 * width[:, None]
    err = (cb - cb_plain).abs()
    if (err > tol).any():
        raise AssertionError(f"{label}: codebooks off the plain version")
    return err.max().item()


def codec_entry(name, err, ms, plain_ms, bound_bytes, library_ms, shape):
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/int8_quant.cu",
            "replaces": "src/repro/kernels/int8_quant.py:" + {
                "encode_hist": "160", "pseudograd_encode_hist": "174",
                "decode": "254", "decode_add": "266"}[name],
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": library_ms,
            "shape": {"rows": shape[0], "n": shape[1], "dtype": "float32"}}


def check_int8_codec() -> list[dict]:
    """Kernels 1-4 at the training ring's hop shape. Library yardsticks:
    ``torch.bincount(codes, weights=x)`` per row for the histogram half
    of encode, ``torch.gather(codebook, 1, codes.long())`` (one
    codebook per row) for decode, ``acc.add_(that)`` for decode_add."""
    from repro_torch.kernels import int8_quant as iq
    from repro_torch.kernels import ref
    rows, n = shape = train_hop_shape()
    gen = torch.Generator(device="cuda").manual_seed(0)
    anchor = torch.randn(shape, generator=gen, device="cuda").mul_(0.02)
    theta = torch.randn(shape, generator=gen, device="cuda").mul_(1e-3)
    theta.add_(anchor)
    scale = torch.tensor([1.0, 0.5, 0.0, 2.0], device="cuda")[:rows]
    out = []

    def encode_phase(name, x, kernel, plain):
        lo, width = ref.quant_params(x)
        got, again = kernel(lo, width), kernel(lo, width)
        want = plain(lo, width)
        torch.cuda.synchronize()
        err = check_hist(name, x, lo, width, got, want, again)
        codes = got[0]
        del got, again, want

        def library():
            return [torch.bincount(codes[r], weights=x[r], minlength=256)
                    for r in range(rows)]
        in_bytes = 9 if name == "pseudograd_encode_hist" else 5
        out.append(codec_entry(
            name, err, time_ms(lambda: kernel(lo, width)),
            time_ms(lambda: plain(lo, width), iters=10),
            rows * n * in_bytes + rows * 256 * 8,
            time_ms(library, iters=10), shape))
        log(f"kernel {name} {shape}: codes and counts exact, repeatable; "
            f"codebook max|err|={err:.3g}; {out[-1]['ms']:.3f} ms "
            f"(bound {out[-1]['bound_ms']:.3f})")
        return codes, ref.make_codebook(*kernel(lo, width)[1:], lo, width)

    # kernel 1 on a pseudo-gradient, kernel 2 fused with per-row scales
    x = ref.pseudograd(anchor, theta)
    codes, book = encode_phase(
        "encode_hist", x, lambda lo, w: iq.encode_hist(x, lo, w),
        lambda lo, w: iq.encode_hist_torch(x, lo, w))
    del x, codes, book
    x = ref.pseudograd(anchor, theta, scale)
    codes, book = encode_phase(
        "pseudograd_encode_hist", x,
        lambda lo, w: iq.pseudograd_encode_hist(anchor, theta, lo, w,
                                                scale=scale),
        lambda lo, w: iq.pseudograd_encode_hist_torch(anchor, theta, lo, w,
                                                      scale=scale))
    del x, anchor, theta
    torch.cuda.empty_cache()

    # kernels 3 and 4 on the fused encode's codes and codebooks
    dec = iq.decode(codes, book)
    torch.cuda.synchronize()
    if not torch.equal(dec, iq.decode_torch(codes, book)):
        raise AssertionError("decode differs from its plain version")
    acc = torch.randn(shape, generator=gen, device="cuda")
    want = acc + dec
    del dec
    got = iq.decode_add(codes, book, acc)
    torch.cuda.synchronize()
    if got.data_ptr() != acc.data_ptr() or not torch.equal(got, want):
        raise AssertionError("decode_add differs from its plain version")
    del want, got
    for name, kernel, plain, library, nbytes in (
            ("decode", lambda: iq.decode(codes, book),
             lambda: iq.decode_torch(codes, book),
             lambda: torch.gather(book, 1, codes.long()), 5),
            ("decode_add", lambda: iq.decode_add(codes, book, acc),
             lambda: iq.decode_add_torch(codes, book, acc),
             lambda: acc.add_(torch.gather(book, 1, codes.long())), 9)):
        out.append(codec_entry(name, 0.0, time_ms(kernel),
                               time_ms(plain, iters=10),
                               rows * n * nbytes + rows * 256 * 4,
                               time_ms(library, iters=10), shape))
        log(f"kernel {name} {shape}: exact; {out[-1]['ms']:.3f} ms "
            f"(bound {out[-1]['bound_ms']:.3f})")
    del codes, book, acc
    torch.cuda.empty_cache()
    return out


def ring_bound(trainer, weights) -> float:
    """What a flipped code can move the outer step's anchor by: one
    bucket width of the widest quantization (6-sigma range over 256
    buckets; std of a sum <= sum of stds), once per ring position, over
    the total weight, times the outer step's lr (1 + mu)."""
    from repro_torch.core.sync_engine import SyncEngine, tree_map
    one = tree_map(lambda p: p[0], trainer.params)
    eng = SyncEngine.for_tree(one)
    a_flat = trainer.outer.anchor_flat
    w = weights.float().cpu()
    stds = [float(w[i]) * float(torch.std(
        a_flat - eng.flatten(tree_map(lambda p: p[i], trainer.params)),
        correction=0)) for i in range(trainer.k)]
    width = 12.0 * sum(stds) / 256
    d = trainer.cfg.diloco
    return (d.outer_lr * (1 + d.outer_momentum) * trainer.k * width
            / max(float(w.sum()), 1e-20))


def check_anchor(label, got, want, bound) -> tuple[float, float]:
    """Ring tolerance: within 1e-5, but for elements whose code flipped
    at a bucket edge, which stay within ``bound`` and are rare."""
    err = (got.float() - want.float()).abs()
    worst, flipped = err.max().item(), (err > 1e-5).float().mean().item()
    if worst > bound or flipped > 0.01:
        raise AssertionError(f"{label}: anchors differ by {worst:.3g} "
                             f"(bound {bound:.3g}), {flipped:.2%} flipped")
    return worst, flipped


@contextlib.contextmanager
def plain_codec():
    """Route the codec wrappers to their plain versions, on any device."""
    from repro_torch.kernels import int8_quant as iq
    saved = {name: getattr(iq, name) for name in CODEC}
    for name in CODEC:
        setattr(iq, name, getattr(iq, name + "_torch"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(iq, name, fn)


def check_reduced_trainer() -> None:
    """The reduced INTELLECT-1 (fp32) trained by the port on the card
    and on the CPU from the same weights and batches: per-step losses
    within rtol 1e-4, final anchors under the ring tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.core.diloco import DiLoCoConfig
    from repro_torch.core.fault_tolerance import ClusterSimulator
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import ElasticTrainer, TrainerConfig
    cfg = get_config("intellect-1").reduced()
    params = get_model(cfg, "cpu").init(0)
    runs, bounds = {}, []
    for dev in ("cpu", "cuda"):
        tr = ElasticTrainer(
            get_model(cfg, dev),
            TrainerConfig(DiLoCoConfig(inner_steps=2), inner_lr=3e-3,
                          max_workers=3),
            DataConfig(vocab=cfg.vocab, seq_len=32, batch_per_worker=2),
            params, ClusterSimulator(range(3)))
        losses, inner, sync = [], tr._run_inner_phase, tr._outer_sync

        def run_inner(b, a, inner=inner, losses=losses):
            losses.append(inner(b, a))
            return losses[-1]

        def outer_sync(w, tr=tr, sync=sync):
            if tr.device.type == "cuda":
                bounds.append(ring_bound(tr, w))
            return sync(w)
        tr._run_inner_phase, tr._outer_sync = run_inner, outer_sync
        tr.run(2)
        runs[dev] = (torch.stack(losses).cpu(), tr.outer.anchor_flat.cpu())
    (lc, ac), (lg, ag) = runs["cpu"], runs["cuda"]
    if not torch.allclose(lg, lc, rtol=1e-4, atol=0.0):
        raise AssertionError(f"reduced trainer GPU vs CPU losses: "
                             f"{lg.tolist()} vs {lc.tolist()}")
    bound = (1 + 0.9) * sum(bounds)
    worst, flipped = check_anchor("reduced trainer GPU vs CPU", ag, ac, bound)
    log(f"reduced intellect-1 trainer GPU vs CPU: losses rtol 1e-4, "
        f"anchor max|err|={worst:.3g} (bound {bound:.3g}), "
        f"flipped {flipped:.2e}")


def train_main_path() -> dict:
    """``launch.train`` at full width; every codec count is set to 0
    just before and read just after."""
    from repro_torch.core import ring_reduce as rr
    from repro_torch.core.sync_engine import leaves
    from repro_torch.kernels import int8_quant as iq
    from repro_torch.launch import train as train_mod
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in CODEC:
        getattr(iq, name).launches = 0
    t0 = time.perf_counter()
    res = train_mod.main(TRAIN_ARGS)
    launches = {name: getattr(iq, name).launches for name in CODEC}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    hist, tr = res["history"], res["trainer"]
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"training: non-finite loss {hist}")
    per_sync = rr.codec_calls(tr.k, tr.cfg.diloco.ring, fused_src=True)
    want = {name: per_sync[name] * len(hist) for name in CODEC}
    if launches != want:
        raise AssertionError(f"training: codec launches {launches}, want "
                             f"{want} ({per_sync} per outer sync)")
    n_params = sum(p[0].numel() for p in leaves(tr.params))
    for h in hist:
        log(f"main path train step {h['outer_step']}: loss={h['loss']:.4f} "
            f"inner={h['inner_s'] * 1e3:.1f}ms "
            f"({h['inner_s'] / tr.cfg.diloco.inner_steps * 1e3:.1f} ms "
            f"per inner step, {tr.k} workers) "
            f"outer_sync={h['sync_s'] * 1e3:.1f}ms "
            f"wire_bytes={h['wire_bytes']}")
    log(f"main path train: params={n_params} launches={launches} "
        f"({per_sync} per outer sync) peak_mem={peak / 2**30:.2f}GiB "
        f"wall={wall:.1f}s")
    return {"history": hist, "trainer": tr, "launches": launches,
            "peak_bytes": peak, "per_sync": per_sync, "params": n_params}


def replay_outer_sync(tr) -> dict:
    """One more inner step gives the workers distinct parameters; the
    outer sync from those inputs then runs with the kernels and again
    with the plain codec on the card, and the anchors must agree."""
    from repro_torch.core import diloco as dl
    live = tr.sim.hb.live_ids()
    batches = {key: v[None].to(tr.device) for key, v in
               tr._batches(tr.cfg.diloco.inner_steps * 10).items()}
    tr._run_inner_phase(batches, tr.slots.live_mask(live))
    tr.opt_state = None                       # the replay needs no AdamW
    torch.cuda.empty_cache()
    weights = torch.as_tensor(tr.slots.live_mask(live), device=tr.device)
    bound = ring_bound(tr, weights)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state = dl.outer_sync_sim(tr.params, tr.outer, tr.cfg.diloco,
                                 weights=weights)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    a_kernel = state.anchor_flat
    del state
    torch.cuda.empty_cache()
    with plain_codec():
        _, state = dl.outer_sync_sim(tr.params, tr.outer, tr.cfg.diloco,
                                     weights=weights)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    worst, flipped = check_anchor("outer sync replay, kernels vs plain",
                                  a_kernel, state.anchor_flat, bound)
    log(f"outer sync replay: kernels {1e3 * (t1 - t0):.1f} ms, plain codec "
        f"{1e3 * (t2 - t1):.1f} ms; anchor max|err|={worst:.3g} "
        f"(bound {bound:.3g}), flipped {flipped:.2e}")
    return {"kernel_s": t1 - t0, "plain_s": t2 - t1, "max_err": worst}


def main() -> None:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = environment()
    build()
    kernels = [check_flash_decode()] + check_int8_codec()
    check_reduced_model()
    check_reduced_trainer()
    runs = {}
    for engine in ("continuous", "wave"):
        for run in (1, 2):          # run 1 also warms the card up
            runs[(engine, run)] = serve(engine, run)
    kernels[0]["launches"] = runs[("continuous", 2)]["launches"]
    summary = {e: {k: runs[(e, 2)][k] for k in (
        "tokens_per_s", "latency_p50_s", "latency_p95_s", "decode_steps",
        "tokens_out", "wall_s", "launches")} for e in ("continuous", "wave")}
    log(f"serve: {json.dumps(summary)}")
    train = train_main_path()
    for entry in kernels[1:]:
        entry["launches"] = train["launches"][entry["name"]]
    last = train["history"][-1]
    codec_ms = sum(e["ms"] * train["per_sync"][e["name"]]
                   for e in kernels[1:])
    log(f"train: outer step {last['outer_step']}: inner phase "
        f"{last['inner_s'] * 1e3:.1f} ms, outer sync "
        f"{last['sync_s'] * 1e3:.1f} ms, codec kernels "
        f"{codec_ms:.2f} ms per sync by their timed ms "
        f"({codec_ms / (last['sync_s'] * 1e3):.1%} of the sync), peak "
        f"{train['peak_bytes'] / 2**30:.2f} GiB")
    replay_outer_sync(train["trainer"])
    del train
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
