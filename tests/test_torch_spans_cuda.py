"""The trainer's spans on the card: under a profiler session every span
reads a device time from its CUDA event pair, and forward, backward and
AdamW cover the inner phase the trainer's host clock times (the rest
of it is the per-slot views and the loss bookkeeping between spans).
Needs a CUDA device and nvcc (skipped without a device); imports no
JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_spans_cuda.py

internlm2-1.8b at full width and 2 layers, 2 workers on 2 slots, 2 rows
of 2048 tokens a worker-step, H = 2: big enough that the host runs
ahead of the card, as in the benchmark's cells."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import ring_reduce as rr
from repro_torch.core.diloco import DiLoCoConfig
from repro_torch.core.fault_tolerance import ClusterSimulator
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.registry import get_model
from repro_torch.train.loop import ElasticTrainer, TrainerConfig

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")

WORKERS, H = 2, 2
TRAIN = ("train.forward", "train.backward", "train.adamw")


@needs_cuda
def test_spans_time_the_inner_phase_on_the_card():
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=2)
    model = get_model(cfg, "cuda")
    tcfg = TrainerConfig(diloco=DiLoCoConfig(inner_steps=H, quant="int8"),
                         max_workers=WORKERS, validation=None)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=2048, batch_per_worker=2)
    tr = ElasticTrainer(model, tcfg, dcfg, model.init(0),
                        ClusterSimulator(list(range(WORKERS)), events=[]))
    assert "spans" not in tr.run(1)[-1]      # builds the kernels
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        rec = dict(tr.run(1)[-1])
    got = rec["spans"]
    codec = sum(rr.codec_calls(WORKERS, tcfg.diloco.ring).values())
    want = dict.fromkeys(TRAIN, WORKERS * H)
    want.update({"codec": codec, "outer.apply": 2})
    assert {n: s["n"] for n, s in got.items()} == want
    for s in got.values():
        assert s["device_ms"] >= 0 and s["host_ms"] > 0
    covered = sum(got[n]["device_ms"] for n in TRAIN) / (1e3 * rec["inner_s"])
    assert 0.9 <= covered <= 1.0 + 1e-3, covered
    # the codec and the apply run inside the sync
    sync = got["codec"]["device_ms"] + got["outer.apply"]["device_ms"]
    assert sync <= 1e3 * rec["sync_s"] * (1.0 + 1e-3)
