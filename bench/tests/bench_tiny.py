"""A checkout of the benchmark at a size a CPU test holds: a copy of
``bench/metrics`` beside a ``BENCHMARK.json`` with one small cell of the
dense or the MoE family (the port's reduced sibling of the cell's
model, registered under its own name), the cell's traffic at 64 tokens
a row and 2 inner steps, and the real cell's limits."""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = {"dense": ("diloco-internlm2-1.8b-4k", "internlm2-1.8b"),
         "moe": ("diloco-deepseek-moe-16b-4k", "deepseek-moe-16b")}


def register(monkeypatch, family: str, dtype: str = "float32") -> str:
    """Register the reduced sibling of the family's model with the
    port's config registry; returns its name."""
    from repro_torch import configs
    base = configs.get_config(CELLS[family][1]).reduced()
    name = f"bench-tiny-{family}"
    monkeypatch.setitem(configs.CONFIGS, name,
                        dataclasses.replace(base, name=name, dtype=dtype))
    return name


def config(name: str, family: str, dtype: str) -> dict:
    from repro_torch import configs
    base = configs.get_config(name)
    c = {"registry": name, "source": "test", "family": family,
         "num_hidden_layers": base.n_layers, "hidden_size": base.d_model,
         "num_attention_heads": base.n_heads,
         "num_key_value_heads": base.n_kv_heads,
         "intermediate_size": base.d_ff, "vocab_size": base.vocab,
         "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
         "tie_word_embeddings": False, "torch_dtype": dtype,
         "assumed": {"head_dim": base.head_dim,
                     "padded_vocab_size": base.padded_vocab,
                     "max_z_weight": 2e-4}}
    if family == "moe":
        m = base.moe
        c.update(moe_intermediate_size=m.d_expert,
                 n_routed_experts=m.n_experts, num_experts_per_tok=m.top_k,
                 n_shared_experts=m.n_shared,
                 first_k_dense_replace=m.first_dense)
        c["assumed"].update(renormalise_top_k=True, capacity_factor=1.25,
                            lb_weight=0.01)
    return c


def make_root(tmp: Path, monkeypatch, family: str,
              dtype: str = "float32") -> tuple[Path, str]:
    """(root, cell name) of a small checkout under ``tmp``."""
    name = register(monkeypatch, family, dtype)
    cell, _ = CELLS[family]
    for d in ("configs", "traffic", "limits"):
        (tmp / "bench" / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "bench" / "metrics", tmp / "bench" / "metrics")
    (tmp / "bench" / "configs" / f"{name}.json").write_text(
        json.dumps(config(name, family, dtype)))
    t = json.loads((ROOT / "bench" / "traffic" / "diloco-4k.json")
                   .read_text())
    t.update(inner_steps=2, seq_len=64)
    (tmp / "bench" / "traffic" / "tiny.json").write_text(json.dumps(t))
    shutil.copy(ROOT / "bench" / "limits" / f"{cell}.json",
                tmp / "bench" / "limits" / f"{name}.json")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"] = [{"name": name, "source": "test",
                     "file": f"bench/configs/{name}.json", "reduced": [],
                     "why": "test"}]
    b["workloads"] = [{"name": name, "config": name, "traffic": "tiny",
                       "chips": 1, "why": "test"}]
    for key in ("end_to_end", "per_layer"):
        for m in b[key]:
            if "workloads" in m:
                m["workloads"] = [name]
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp, name
