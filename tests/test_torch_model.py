"""repro_torch's dense model against repro's on the same weights
(converted with from_jax_params): right-padded mixed-length prefill
(logits and cache), then decode steps through the flash-decode path
(the Pallas kernel in interpret mode on the JAX side, the kernel's plain
version on the port's CPU side). fp32, tolerance 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.configs.base import ShapeConfig
from repro.models.registry import get_model as jget_model
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.convert import from_jax_cache, from_jax_params, to_tensor
from repro_torch.models.registry import get_model as tget_model

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = 1e-4


def _pair(arch):
    jcfg = dataclasses.replace(JCONFIGS[arch].reduced(),
                               decode_attn_impl="pallas")
    jm = jget_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    jm = dataclasses.replace(jm, prefill=jax.jit(jm.prefill),
                             decode=jax.jit(jm.decode))
    tm = tget_model(TCONFIGS[arch].reduced(), "cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, jm, params, tm, tp


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,max_len", [("intellect-1", 48),
                                          ("h2o-danube-1.8b", 48)])
def test_prefill_and_decode_match_reference(arch, max_len):
    """h2o-danube's reduced window (32) is below max_len, so its cache
    is a ring the decode steps wrap."""
    cfg, jm, params, tm, tp = _pair(arch)
    b, width = 3, 24
    rng = np.random.default_rng(11)
    plen = np.array([24, 5, 13], np.int32)
    toks = rng.integers(2, cfg.vocab, size=(b, width)).astype(np.int32)
    for i in range(b):
        toks[i, plen[i]:] = 0                       # right-pad
    shape = ShapeConfig("t", "decode", max_len, b)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks),
                                 "prompt_len": jnp.asarray(plen)},
                        jm.init_cache(b, shape))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "prompt_len": torch.from_numpy(plen)},
                        tm.init_cache(b, shape))
    _close(tl, jl)
    for name in ("k", "v", "length"):
        _close(getattr(tc["scan"], name), getattr(jc["scan"], name))
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    for _ in range(8):
        jl, jc = jm.decode(params, jnp.asarray(tok), jc)
        tl, tc = tm.decode(tp, torch.from_numpy(tok), tc)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(tc["scan"].length.numpy(),
                                  np.asarray(jc["scan"].length))


def test_converted_cache_decodes_like_reference():
    """from_jax_cache: a JAX-prefilled cache decodes in the port."""
    cfg, jm, params, tm, tp = _pair("intellect-1")
    shape = ShapeConfig("t", "decode", 32, 2)
    toks = np.random.default_rng(3).integers(
        2, cfg.vocab, size=(2, 8)).astype(np.int32)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(2, shape))
    tc = from_jax_cache(jax.tree.map(np.asarray, jc), "cpu")
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    jl, _ = jm.decode(params, jnp.asarray(tok), jc)
    tl, _ = tm.decode(tp, torch.from_numpy(tok), tc)
    _close(tl, jl)


def test_bf16_conversion_is_bit_exact():
    a = jnp.asarray(np.random.default_rng(0).normal(size=(5, 7)),
                    jnp.bfloat16)
    t = to_tensor(np.asarray(a), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(a).view(np.int16))


def test_init_scales_and_layout():
    """Random init follows repro's layout and ParamBuilder's scales."""
    cfg = TCONFIGS["intellect-1"].reduced()
    p = tget_model(cfg, "cpu").init(0)
    n, d, hd = cfg.n_layers, cfg.d_model, cfg.head_dim
    assert p["layers"]["wq"].shape == (n, d, cfg.n_heads * hd)
    assert p["layers"]["mlp"]["down"].shape == (n, cfg.d_ff, d)
    assert p["lm_head"].shape == (d, cfg.padded_vocab)
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    assert abs(p["layers"]["wq"].std().item() - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(p["layers"]["mlp"]["down"].std().item()
               - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert torch.equal(p["layers"]["ln_attn"], torch.ones(n, d))
    assert not torch.equal(p["layers"]["wq"][0], p["layers"]["wq"][1])


def test_other_families_raise():
    """Enc-dec builds (its ModelDef has no bare logits forward); the
    engines refuse it with ValueError, and an unknown family raises."""
    from repro_torch.serving.engine import ContinuousEngine
    model = tget_model(TCONFIGS["seamless-m4t-medium"].reduced(), "cpu")
    assert model.cfg.family == "encdec" and model.logits is None
    with pytest.raises(ValueError, match="encdec"):
        ContinuousEngine(model, model.init(0), batch_slots=1, max_len=16)
    with pytest.raises(ValueError, match="unknown family"):
        tget_model(dataclasses.replace(TCONFIGS["intellect-1"].reduced(),
                                       family="rnn"), "cpu")
