"""Chip smoke test of the PyTorch / H100 port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card and nvcc; imports nothing of JAX or of ``repro``.
Phases, each of which raises on failure (nothing is caught):

1. environment: the card (nvidia-smi name and power limit), torch, CUDA
   and nvcc versions;
2. build: every CUDA kernel of the serving path, from the sources in
   this checkout (``src/repro_torch/kernels/csrc``);
3. kernels: each kernel against its plain PyTorch version on the card,
   at the serving path's shapes, with its time, its plain version's
   time, the time of the nearest single PyTorch call (a yardstick the
   port never calls) and the least time the card could take;
4. main path: ``repro_torch.launch.serve`` serves INTELLECT-1 at full
   width and depth (random weights from a seed) with the continuous and
   the wave engine; every request must finish with in-vocabulary tokens
   and the kernel must launch once per layer per decode step; a reduced
   model on the card must agree with the same model on the CPU.

The last two lines are the card (name, power limit) and the result.
"""
from __future__ import annotations

import json
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


def main() -> None:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    smi = environment()
    build()
    kernel = check_flash_decode()
    check_reduced_model()
    runs = {}
    for engine in ("continuous", "wave"):
        for run in (1, 2):          # run 1 also warms the card up
            runs[(engine, run)] = serve(engine, run)
    kernel["launches"] = runs[("continuous", 2)]["launches"]
    summary = {e: {k: runs[(e, 2)][k] for k in (
        "tokens_per_s", "latency_p50_s", "latency_p95_s", "decode_steps",
        "tokens_out", "wall_s", "launches")} for e in ("continuous", "wave")}
    log(f"serve: {json.dumps(summary)}")
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
