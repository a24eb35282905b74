"""The yardstick's counts, pinned at both cells' shapes against values
worked out by hand, so that no change to the program can move them."""
from __future__ import annotations

import json
import sys

import pytest

pytest.importorskip("torch")

from bench_tiny import ROOT  # noqa: E402

sys.path[:0] = [str(ROOT)]
from bench import flops, weights  # noqa: E402
from bench.reference import model  # noqa: E402

# internlm2-1.8b, 6 layers: attention 2048 x 128 x (2 x 16 + 2 x 8) =
# 12,582,912 and SwiGLU 3 x 2048 x 8192 = 50,331,648 a layer, the head
# 2048 x 92,544; attention scores 6 x 6 x 4096 x 2048 a token.
# Parameters held: embedding and head 2 x 92,672 x 2048, ln_f 2048,
# 6 x (12,582,912 + 50,331,648 + 2 x 2048).
# deepseek-moe-16b, the dense layer and 1 MoE layer: attention
# 2048 x 128 x 64 = 16,777,216 a layer, the dense SwiGLU
# 3 x 2048 x 10,944 = 67,239,936, the MoE layer's router 2048 x 64 and
# (6 routed + 2 shared) x 3 x 2048 x 1408; the head 2048 x 102,400.
# Held: 2 x 102,400 x 2048 + 2048 + (16,777,216 + 67,239,936 + 4096) +
# (16,777,216 + 4096 + 131,072 + 64 x 3 x 2048 x 1408
#  + 3 x 2048 x 2 x 1408).
# Codec bytes of one sync over 2 workers, e = n elements: fused encode
# 7e (+ 24 + 4096), decode-add 9e (+ 2048), encode 5e (+ 16 + 4096),
# two decodes 5e each (+ 2048 each): 31 e + 14,376.
CELLS = {
    "internlm2-1.8b": dict(active=567_017_472, per_token=3_704_094_720,
                           held=757_098_496, codec=23_470_067_752),
    "deepseek-moe-16b": dict(active=379_846_656, per_token=2_379_743_232,
                             held=1_091_315_712, codec=33_830_801_448),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_counts_at_the_cells_shapes(name):
    want = CELLS[name]
    c = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    t = json.loads((ROOT / "bench" / "traffic" / "diloco-4k.json")
                   .read_text())
    assert flops.active_params(c) == want["active"]
    assert flops.flops_per_token(c, t["seq_len"]) == want["per_token"]
    assert weights.numel(model.spec_from_config(c)) == want["held"]
    assert flops.codec_bytes_per_sync(want["held"], t["workers"], 2) \
        == want["codec"]


def test_codec_bytes_grow_with_the_ring():
    # three workers: a plain encode on the second reduce-scatter hop, a
    # second decode-add, a third decode
    n = 3 * 1000
    two = flops.codec_bytes_per_sync(n, 2, 2)
    three = flops.codec_bytes_per_sync(n, 3, 2)
    e = 3000
    assert three == (7 * e + 36 + 6144) + (5 * e + 24 + 6144) \
        + 2 * (9 * e + 3072) + (5 * e + 24 + 6144) + 3 * (5 * e + 3072)
    assert two < three
