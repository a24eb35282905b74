"""repro_torch's encoder-decoder (``models/encdec.py``: the reduced
seamless-m4t-medium, 1 encoder and 1 decoder layer, and a 2 + 2 layer
variant of it) against repro's on the same weights (converted with
from_jax_params), fp32 on the CPU.

Floats are held with ``allclose`` at TOL = 1e-4 (absolute and relative),
as ``test_torch_model.py``: the encoder memory, the loss and its metrics,
every parameter's gradient, the prefill's logits and every cache leaf
(through ``convert.from_jax_cache``), and 8 decode steps' logits (the
reference's decode attention is the Pallas kernel in interpret mode, the
port's the kernel's plain version). Greedy tokens are held exactly. The
engines and ``launch.serve`` refuse the family with ``ValueError``;
``GRPOModel`` refuses it with ``TypeError``, as repro's does. A decode
over sequence-laid blocks of the self and cross caches (each of its own
capacity; ranks as threads) merges to the whole cache's within 1e-5."""
import dataclasses
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import encdec as jencdec
from repro.models import registry as jregistry
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import from_jax_cache, from_jax_params
from repro_torch.core.sync_engine import leaves
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import registry

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

TOL = 1e-4
ARCH = "seamless-m4t-medium"
SRC, MAX_LEN, B = 24, 24, 3


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=[2, 4], ids=["reduced", "2+2"])
def pair(request):
    """repro's reduced model (decode through the Pallas kernel in
    interpret mode) and the port's on the same weights, at
    ``n_layers`` = request.param."""
    n = request.param
    jcfg = dataclasses.replace(JCONFIGS[ARCH].reduced(), n_layers=n,
                               decode_attn_impl="pallas")
    jm = jregistry.get_model(jcfg)
    jp = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    jm = dataclasses.replace(jm, prefill=jax.jit(jm.prefill),
                             decode=jax.jit(jm.decode))
    cfg = dataclasses.replace(TCONFIGS[ARCH].reduced(), n_layers=n)
    return types.SimpleNamespace(
        jcfg=jcfg, jm=jm, jp=jp, cfg=cfg,
        model=registry.get_model(cfg, "cpu"),
        params=from_jax_params(jax.tree.map(np.asarray, jp), "cpu"))


def _src(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab, size=(b, s)).astype(np.int32)


def _train_batch(cfg, seed=0):
    half = 12
    mask = np.ones((B, half), np.float32)
    mask[1, 7:] = 0.0
    return {"src_embeds": _src(cfg, B, half, seed),
            "tokens": _tokens(cfg, B, half, seed + 1),
            "targets": _tokens(cfg, B, half, seed + 2), "mask": mask}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- model --------------------------------------------------------------------


def test_init_layout_matches_reference(pair):
    """The port's random init has repro's tree, shapes and dtypes, with
    its norm gains exactly ones, and repro's scales."""
    p = pair.model.init(0)
    jflat = jax.tree_util.tree_flatten_with_path(pair.jp)[0]
    tflat = {tuple(k): v for k, v in _paths(p)}
    assert len(jflat) == len(tflat)
    for path, arr in jflat:
        key = tuple(e.key for e in path)
        assert tuple(tflat[key].shape) == arr.shape, key
        assert str(tflat[key].dtype).removeprefix("torch.") == str(arr.dtype)
        if key[-1].startswith("ln"):
            assert torch.equal(tflat[key], torch.ones_like(tflat[key]))
    d = pair.cfg.d_model
    assert abs(p["embed"].std().item() - 0.02) < 2e-3
    assert abs(p["dec"]["cross"]["wq"].std().item() - d ** -0.5) \
        < 0.1 * d ** -0.5


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def test_encode_and_loss_match_reference(pair):
    batch = _train_batch(pair.cfg)
    jmem = jencdec.encode(pair.jcfg, pair.jp, jnp.asarray(batch["src_embeds"]))
    tmem = tencdec.encode(pair.cfg, pair.params,
                          torch.from_numpy(batch["src_embeds"]))
    _close(tmem, jmem)
    jl, jmet = pair.jm.loss(pair.jp, jax.tree.map(jnp.asarray, batch))
    tl, tmet = pair.model.loss(pair.params, _torch_batch(batch))
    _close(tl, jl)
    for k in ("ce", "z", "loss"):
        _close(tmet[k], jmet[k])


def test_loss_gradient_matches_reference(pair):
    batch = _train_batch(pair.cfg, seed=5)
    jg = jax.grad(lambda p: pair.jm.loss(p, jax.tree.map(
        jnp.asarray, batch))[0])(pair.jp)
    tp = from_jax_params(jax.tree.map(np.asarray, pair.jp), "cpu")
    for t in leaves(tp):
        t.requires_grad_(True)
    loss, _ = pair.model.loss(tp, _torch_batch(batch))
    loss.backward()
    tflat = dict(_paths(tp))
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = tuple(e.key for e in path)
        _close(tflat[key].grad, g)


def _prefill_both(pair, src_len=SRC, seed=7):
    src = _src(pair.cfg, B, src_len, seed)
    bos = np.ones((B, 1), np.int32)
    shape = JShapeConfig("t", "decode", MAX_LEN, B)
    jl, jc = pair.jm.prefill(pair.jp, {"src_embeds": jnp.asarray(src),
                                       "bos": jnp.asarray(bos)},
                             pair.jm.init_cache(B, shape))
    tl, tc = pair.model.prefill(
        pair.params, {"src_embeds": torch.from_numpy(src),
                      "bos": torch.from_numpy(bos)},
        pair.model.init_cache(B, ShapeConfig("t", "decode", MAX_LEN, B)))
    return jl, jc, tl, tc


def test_prefill_logits_and_cache_match_reference(pair):
    jl, jc, tl, tc = _prefill_both(pair)
    _close(tl, jl)
    for name in ("k", "v", "length"):
        _close(getattr(tc["self"], name), getattr(jc["self"], name))
    for name in ("cross_k", "cross_v", "src_len"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])
    np.testing.assert_array_equal(tc["src_len"].numpy(), [SRC] * B)
    np.testing.assert_array_equal(tc["self"].length.numpy(),
                                  np.ones((pair.cfg.n_layers // 2, B)))


def test_decode_steps_match_reference(pair):
    """8 greedy decode steps after the prefill: logits within TOL of
    repro's each step, greedy tokens equal, self-cache lengths equal."""
    jl, jc, tl, tc = _prefill_both(pair)
    jtoks, ttoks = [], []
    for _ in range(8):
        jt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        tt = tl.argmax(-1, keepdim=True).to(torch.int32)
        jtoks.append(jt)
        ttoks.append(tt.numpy())
        jl, jc = pair.jm.decode(pair.jp, jnp.asarray(jt), jc)
        tl, tc = pair.model.decode(pair.params, tt, tc)
        _close(tl, jl)
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))
    np.testing.assert_array_equal(tc["self"].length.numpy(),
                                  np.asarray(jc["self"].length))


def test_short_source_in_a_wider_cross_cache(pair):
    """A source shorter than the cross cache's capacity is masked by
    ``src_len``: the logits equal repro's, whose cross cache takes the
    source's own length."""
    src = _src(pair.cfg, B, 10, 3)
    bos = np.ones((B, 1), np.int32)
    jl, jc = pair.jm.prefill(pair.jp, {"src_embeds": jnp.asarray(src),
                                       "bos": jnp.asarray(bos)},
                             pair.jm.init_cache(
                                 B, JShapeConfig("t", "decode", 10, B)))
    tl, tc = pair.model.prefill(
        pair.params, {"src_embeds": torch.from_numpy(src),
                      "bos": torch.from_numpy(bos)},
        pair.model.init_cache(B, ShapeConfig("t", "decode", MAX_LEN, B)))
    _close(tl, jl)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    jl, _ = pair.jm.decode(pair.jp, jnp.asarray(tok), jc)
    tl, _ = pair.model.decode(pair.params, torch.from_numpy(tok), tc)
    _close(tl, jl)
    with pytest.raises(ValueError, match="capacity"):
        pair.model.prefill(
            pair.params, {"src_embeds": torch.from_numpy(src),
                          "bos": torch.from_numpy(bos)},
            pair.model.init_cache(B, ShapeConfig("t", "decode", 8, B)))


def test_converted_cache_decodes_like_reference(pair):
    """from_jax_cache carries the enc-dec tree: a JAX-prefilled cache
    decodes in the port."""
    jl, jc, _, _ = _prefill_both(pair, seed=9)
    tc = from_jax_cache(jax.tree.map(np.asarray, jc), "cpu")
    assert isinstance(tc["self"], tattn.KVCache)
    tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
    jl, _ = pair.jm.decode(pair.jp, jnp.asarray(tok), jc)
    tl, _ = pair.model.decode(pair.params, torch.from_numpy(tok), tc)
    _close(tl, jl)


def test_decoder_logits_teacher_forcing_match_decode(pair):
    """The teacher-forced decoder over [BOS, emitted tokens] gives each
    decode step's logits (the card gate of ``chip_smoke.py``)."""
    _, _, tl, tc = _prefill_both(pair, seed=4)
    steps, toks = [tl], [torch.ones((B, 1), dtype=torch.int32)]
    for _ in range(6):
        tok = steps[-1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok)
        lg, tc = pair.model.decode(pair.params, tok, tc)
        steps.append(lg)
    src = torch.from_numpy(_src(pair.cfg, B, SRC, 4))
    with torch.no_grad():
        mem = tencdec.encode(pair.cfg, pair.params, src)
        full = tencdec.decoder_logits(pair.cfg, pair.params, mem,
                                      torch.cat(toks, 1))
    for j, lg in enumerate(steps):
        _close(lg, full[:, j].numpy())


def _thread_gathers(n: int) -> list:
    """The all-gather of n threads, one callable a thread: each returns
    the list of every thread's tensor in thread order."""
    slots = [None] * n
    barrier = threading.Barrier(n, timeout=60)

    def make(r):
        def gather(t):
            slots[r] = t
            barrier.wait()
            out = list(slots)
            barrier.wait()
            return out
        return gather
    return [make(r) for r in range(n)]


def test_sequence_laid_blocks_decode_as_the_whole_cache(pair):
    """``decode_step`` on 3 ranks' blocks of one prefilled cache (ranks
    as threads, the merge's gather between them): the self cache of 12
    cells in blocks of 4 and the cross cache of ANOTHER capacity, 24
    cells in blocks of 8 (its layout the tree's ``cross_layout``, not
    the self cache's), a 9-frame source, so rank 2's cross block is
    empty every step and ranks 1-2's self blocks are empty at the first
    step. 6 steps (the self cache crosses a block boundary): every
    rank's logits finite and within 1e-5 of the whole cache's decode,
    and so are the self blocks of the whole cache's cells."""
    cfg, model, params = pair.cfg, pair.model, pair.params
    n, s_self, s_cross, sl = 3, 12, 24, 9
    whole = tencdec.init_cache(cfg, B, s_self, s_cross, device="cpu")
    logits, whole = model.prefill(
        params, {"src_embeds": torch.from_numpy(_src(cfg, B, sl, 5)),
                 "bos": torch.ones((B, 1), dtype=torch.int32)}, whole)
    gathers = _thread_gathers(n)
    sb, cb = s_self // n, s_cross // n

    def block(r):
        sc = whole["self"]
        cut = lambda t, w: t[:, :, r * w:(r + 1) * w].clone()
        return {"self": tattn.KVLayout(
                    seq=(r * sb, s_self), all_gather=gathers[r]).view(
                    cut(sc.k, sb), cut(sc.v, sb), sc.length.clone()),
                "cross_k": cut(whole["cross_k"], cb),
                "cross_v": cut(whole["cross_v"], cb),
                "src_len": whole["src_len"].clone(),
                "cross_layout": tattn.KVLayout(seq=(r * cb, s_cross),
                                               all_gather=gathers[r])}
    caches = [block(r) for r in range(n)]
    assert (tattn.block_length(whole["src_len"], 2 * cb, cb, s_cross)
            == 0).all()
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    with ThreadPoolExecutor(n) as pool:
        for step in range(6):
            want, whole = model.decode(params, tok, whole)
            got = list(pool.map(
                lambda r: model.decode(params, tok, caches[r])[0],
                range(n)))
            for r, lg in enumerate(got):
                assert torch.isfinite(lg).all(), (step, r)
                _close(lg, want.numpy(), tol=1e-5)
            tok = want.argmax(-1, keepdim=True).to(torch.int32)
    for name in ("k", "v"):
        _close(torch.cat([getattr(c["self"], name) for c in caches], dim=2),
               getattr(whole["self"], name).numpy(), tol=1e-5)


def test_registry_cache_shapes():
    """The self cache holds min(4096, seq_len) cells, the cross cache
    seq_len frames (seq_len // 2 for ``train``); enc-dec exposes no bare
    logits forward and no prefill_extend; the stage partition refuses
    it."""
    cfg = TCONFIGS[ARCH]
    model = registry.get_model(cfg, "meta")
    assert model.logits is None and model.prefill_extend is None
    hd = cfg.d_model // cfg.n_heads
    c = model.init_cache(2, ShapeConfig("s", "decode", 8192, 2))
    assert tuple(c["self"].k.shape) == (6, 2, 4096, 16, hd)
    assert tuple(c["cross_k"].shape) == (6, 2, 8192, 16, hd)
    c = model.init_cache(2, ShapeConfig("s", "train", 1024, 2))
    assert tuple(c["cross_v"].shape) == (6, 2, 512, 16, hd)
    assert registry.get_model(cfg).device.type == "cuda"
    with pytest.raises(ValueError, match="stage partition"):
        registry.make_stages(cfg.reduced(), 1, "cpu")


def test_full_size_parameter_count():
    """seamless-m4t-medium's tree, on the meta device, has repro's
    parameter count (its abstract init: about 0.75 B), the analytic
    count plus the norm gains."""
    cfg = TCONFIGS[ARCH]
    n = sum(t.numel() for t in leaves(tencdec.alloc_encdec(cfg,
                                                           device="meta")))
    jm = jregistry.get_model(JCONFIGS[ARCH])
    spec = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(spec))
    n_enc, n_dec = tencdec.n_enc_dec(cfg)
    gains = cfg.d_model * (2 + 2 * n_enc + 3 * n_dec)
    assert n == cfg.param_count() + gains
    assert 0.7e9 < n < 0.8e9


# -- refusals -----------------------------------------------------------------


@pytest.mark.parametrize("engine", ["wave", "continuous", "paged"])
def test_engines_refuse_encdec(engine):
    from repro_torch.serving.engine import make_engine
    cfg = TCONFIGS[ARCH].reduced()
    model = registry.get_model(cfg, "cpu")
    with pytest.raises(ValueError, match="encdec"):
        make_engine(engine, model, model.init(0), batch_slots=2, max_len=32)


@pytest.mark.parametrize("argv", [["--reduced"], ["--reduced", "--swarm"],
                                  []])
def test_serve_refuses_encdec(argv):
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="encdec"):
        serve.main(["--device", "cpu", "--arch", ARCH, *argv])


def test_grpo_model_refuses_encdec():
    from repro_torch.rl.grpo import GRPOModel
    model = registry.get_model(TCONFIGS[ARCH].reduced(), "cpu")
    with pytest.raises(TypeError, match="logits"):
        GRPOModel(model)
