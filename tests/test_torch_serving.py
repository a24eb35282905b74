"""repro_torch's serving engines: greedy tokens equal to repro's
ContinuousEngine on the same weights, wave == continuous inside the
port, sampled streams independent of slot placement, and the package
boundary (no JAX, no repro) of the port's entry points."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models.registry import get_model as jget_model
from repro.serving import engine as jengine
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.convert import from_jax_params
from repro_torch.models.registry import get_model as tget_model
from repro_torch.serving import engine as tengine

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

ARCH = "intellect-1"
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JCONFIGS[ARCH].reduced(),
                               decode_attn_impl="pallas")
    jm = jget_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = tget_model(TCONFIGS[ARCH].reduced(), "cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, params), "cpu")
    return jm, params, tm, tp


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=int(rng.integers(3, 30))
                         ).astype(np.int32) for _ in range(n)]


def _run(mod, kind, model, params, prompts, *, slots=4, max_new=10,
         temps=None, order=None, **kw):
    eng = mod.make_engine(kind, model, params, batch_slots=slots,
                          max_len=64, **kw)
    reqs = [mod.Request(i, p, max_new_tokens=max_new if i % 2 else 6,
                        temperature=0.0 if temps is None else temps[i])
            for i, p in enumerate(prompts)]
    for i in (order or range(len(reqs))):
        eng.submit(reqs[i])
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], eng


def test_continuous_greedy_equals_reference(models):
    jm, params, tm, tp = models
    prompts = _prompts(6, TCONFIGS[ARCH].reduced().vocab)
    ref, _ = _run(jengine, "continuous", jm, params, prompts)
    out, eng = _run(tengine, "continuous", tm, tp, prompts)
    assert out == ref
    assert eng.stats["host_syncs"] == eng.stats["decode_chunks"]


def test_wave_equals_continuous(models):
    _, _, tm, tp = models
    prompts = _prompts(6, TCONFIGS[ARCH].reduced().vocab, seed=1)
    cont, _ = _run(tengine, "continuous", tm, tp, prompts)
    wave, eng = _run(tengine, "wave", tm, tp, prompts)
    assert wave == cont
    assert eng.stats["waves"] == 2


def test_sampled_tokens_independent_of_slot(models):
    """The same (seed, rid) gives the same sampled tokens whatever slot
    the request lands in and whatever runs beside it."""
    _, _, tm, tp = models
    prompts = _prompts(6, TCONFIGS[ARCH].reduced().vocab, seed=2)
    temps = [0.9, 0.0, 1.3, 0.7, 0.0, 1.0]
    kw = dict(temps=temps, seed=5, top_k=40, top_p=0.95)
    a, _ = _run(tengine, "continuous", tm, tp, prompts, **kw)
    b, _ = _run(tengine, "continuous", tm, tp, prompts, slots=3,
                order=[5, 3, 1, 0, 2, 4], batch_admit=False, **kw)
    assert a == b
    c, _ = _run(tengine, "continuous", tm, tp, prompts,
                temps=temps, seed=6, top_k=40, top_p=0.95)
    assert c != a                    # another engine seed, other draws
    greedy, _ = _run(tengine, "continuous", tm, tp, prompts)
    assert [a[i] for i in (1, 4)] == [greedy[i] for i in (1, 4)]


def test_wave_rejects_sampling(models):
    _, _, tm, tp = models
    eng = tengine.make_engine("wave", tm, tp, batch_slots=2, max_len=32)
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit(tengine.Request(0, np.arange(2, 6, dtype=np.int32),
                                   temperature=0.5))


def test_sample_tokens_masks():
    logits = torch.tensor([[0.0, 3.0, 2.0, 1.0, -1.0]])
    keep = tengine.nucleus_mask(logits, 0.5)
    assert keep.tolist() == [[False, True, False, False, False]]
    temps = torch.tensor([1.0])
    for seed in range(20):
        gen = torch.Generator().manual_seed(seed)
        noise = tengine.gumbel(gen, 5, "cpu")[None]
        tok = tengine.sample_tokens(logits, temps, noise, top_k=2)
        assert int(tok) in (1, 2)
    assert int(tengine.sample_tokens(logits, torch.tensor([0.0]),
                                     noise)) == 1
    assert [tengine.bucket_len(n) for n in (1, 8, 9, 100)] == \
        [8, 8, 16, 128]
    assert [tengine.bucket_batch(n) for n in (1, 3, 4, 5)] == [1, 4, 4, 8]


def test_port_imports_neither_jax_nor_repro(tmp_path):
    """No module of the port imports JAX or ``repro``: neither in an
    importing process nor in the rank processes of a distributed ring
    (a 2-rank CPU mesh runs one reduction, then each rank lists its
    modules)."""
    bad = ("bad = [m for m in sys.modules if m == 'jax' or "
           "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
           "m.startswith('repro.') or m == 'ml_dtypes' or "
           "m.startswith('ml_dtypes.')]\n")
    code = ("import sys, torch, repro_torch, repro_torch.launch.serve, "
            "repro_torch.serving.engine, repro_torch.serving.paging, "
            "repro_torch.kernels.flash_decode, "
            "repro_torch.convert, repro_torch.launch.train, "
            "repro_torch.launch.profile_train, "
            "repro_torch.train.loop, repro_torch.kernels.ref, "
            "repro_torch.kernels.int8_quant, repro_torch.kernels.ops, "
            "repro_torch.core.sync_engine, repro_torch.core.ring_reduce, "
            "repro_torch.core.diloco, repro_torch.core.fault_tolerance, "
            "repro_torch.core.elastic_mesh, repro_torch.core.topology, "
            "repro_torch.core.compression, repro_torch.core.validation, "
            "repro_torch.core.rank_mesh, repro_torch.train.step, "
            "repro_torch.launch.mesh, repro_torch.sharding.partition, "
            "repro_torch.optim.adamw, "
            "repro_torch.optim.nesterov, repro_torch.optim.schedules, "
            "repro_torch.data.pipeline, repro_torch.models.common, "
            "repro_torch.models.transformer, repro_torch.models.registry, "
            "repro_torch.models.moe, repro_torch.models.attention, "
            "repro_torch.launch.profile_decode, "
            "repro_torch.checkpointing, "
            "repro_torch.checkpointing.checkpoint, "
            "repro_torch.checkpointing.store, "
            "repro_torch.checkpointing.snapshot, "
            "repro_torch.checkpointing.delta, repro_torch.checkpointing.p2p, "
            "repro_torch.checkpointing.gossip, "
            "repro_torch.checkpointing.swarm, "
            "repro_torch.checkpointing.streaming, repro_torch.serving, "
            "repro_torch.serving.swarm_serve\n"
            + bad + "assert not bad, bad\n\n"
            "def rank_modules(ctx):\n"
            "    " + bad.replace("\n", "\n    ") + "return bad\n\n"
            "if __name__ == '__main__':\n"
            "    from repro_torch.launch.mesh import make_host_mesh\n"
            "    from repro_torch.train import step\n"
            "    with make_host_mesh(2, device='cpu') as mesh:\n"
            "        pr = step.DistSyncPrograms(mesh, 'data', 64,\n"
            "            repro_torch.core.ring_reduce.RingConfig())\n"
            "        step.DistRingSyncOp(pr, torch.randn(2, 64)).finish()\n"
            "        assert mesh.call(rank_modules) == [[], []]\n")
    script = tmp_path / "boundary.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    subprocess.run([sys.executable, str(script)], check=True, env=env,
                   timeout=120)


def test_serve_defaults_to_cuda():
    from repro_torch.launch import serve
    assert serve.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


def test_serve_main_on_cpu(capsys):
    from repro_torch.launch import serve
    s = serve.main(["--device", "cpu", "--reduced", "--requests", "3",
                    "--max-new", "4", "--max-len", "32"])
    assert s["requests"] == 3 and all(s["done"])
    assert all(0 <= t < s["padded_vocab"] for o in s["outputs"] for t in o)
    assert "tok/s=" in capsys.readouterr().out


def test_serve_main_paged_on_cpu(capsys):
    from repro_torch.launch import serve
    s = serve.main(["--device", "cpu", "--reduced", "--engine", "paged",
                    "--requests", "3", "--max-new", "4", "--max-len", "32",
                    "--block-size", "8", "--pool-blocks", "9"])
    assert s["engine"] == "paged" and s["requests"] == 3 and all(s["done"])
    assert all(0 <= t < s["padded_vocab"] for o in s["outputs"] for t in o)
    assert s["block_size"] == 8 and s["pool_blocks"] == 8
    assert 0 < s["blocks_peak"] <= 8
    for key in ("prefix_hits", "prefix_hit_rate", "cow_forks",
                "paged_extends", "cold_blocks"):
        assert key in s
    assert "prefix_hit_rate=" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--arch", "mamba2-130m"],
                                  ["--arch", "seamless-m4t-medium"]])
def test_serve_unported_paths_raise(argv):
    """The families that are not ported yet (SSM, enc-dec) raise."""
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError):
        serve.main(["--device", "cpu", "--reduced", *argv])


def test_serve_main_swarm_on_cpu(capsys):
    """``--swarm``: a 2-stage x 2-replica fleet whose mid-chain holder
    crashes mid-run gives the single-host engine's greedy tokens."""
    from repro_torch.launch import serve
    s = serve.main(["--swarm", "--device", "cpu", "--reduced",
                    "--arch", "internlm2-1.8b", "--stages", "2",
                    "--replicas", "2", "--requests", "3", "--max-new", "6",
                    "--max-len", "64"])
    assert s["bit_identical_to_engine"] and s["outputs"] == s["reference"]
    assert s["failovers"] >= 1 and s["recoveries"] >= 1
    assert "bit_identical_to_engine=True" in capsys.readouterr().out
