"""The port's sharded serve step (``repro_torch.train.step.
build_serve_step``, ``local_cache``, ``ModelDef.cache_pspecs``; the
rank driver ``launch.shard_serve``) on one (2, 4) ("data", "model") gloo
mesh of rank processes on the CPU, against ``repro``'s unsharded
``prefill`` / ``decode`` (jitted, CPU JAX) on the same weights.

Each reduced config serves 4 right-padded prompts of up to 39 positions
(2 rows a rank; a sequence split over 4 ranks is uneven) and 8 greedy
decode steps:

  * internlm2-1.8b: 2 KV heads do not divide 'model' (4), so the cache
    is laid by sequence (12 of 48 cells a rank, decode through the
    kernel's block variant merged over 'model') and the prefill splits
    the sequence; a slot crosses a block boundary while decoding;
  * h2o-danube-1.8b: the same on a sliding-window ring of 32 cells in
    blocks of 8, wrapped by the prompts and by decoding;
  * dbrx-132b: an MoE under the sequence split (full capacity);
  * phi-3-vision-4.2b: the frontend joined before the step, KV heads
    over 'model';
  * seamless-m4t-medium: the self and cross caches by heads; with 2 KV
    heads (not dividing 'model') both by sequence, the prefill's split
    over a 41-frame source in the 48-cell cross cache, 14 decode steps;
  * mamba2-130m, zamba2-2.7b: SSM states by heads, conv rings by
    channels, zamba2's shared-attention KV by heads.

Every case: greedy tokens equal ``repro``'s; logits within 1e-4 (the
families' parity tolerance) and the same on every rank; every cache
leaf, assembled from the ranks' blocks by ``repro``'s specs, within 1e-4
of ``repro``'s cache, each rank holding exactly ``local_shape`` of its
spec.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import serve_ranks as sr
from repro.configs import CONFIGS as JCONFIGS
from repro.configs.base import ShapeConfig as JShape
from repro.models.registry import get_model as jget_model
from repro.sharding import make_plan as jmake_plan
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import partition

torch.set_float32_matmul_precision("highest")

AMAP = {"data": 2, "model": 4}
B, S, MAX_LEN, N_DECODE = 4, 39, 48, 8
TOL = 1e-4
ARCHS = ["internlm2-1.8b", "h2o-danube-1.8b", "dbrx-132b",
         "phi-3-vision-4.2b", "seamless-m4t-medium", "mamba2-130m",
         "zamba2-2.7b"]


@pytest.fixture(scope="module")
def mesh():
    with make_mesh((2, 4), ("data", "model"), device="cpu",
                   timeout=300.0) as m:
        yield m


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        # the source fills the cross cache (repro's takes the source's
        # length, the port's its capacity)
        return {"src_embeds": rng.normal(size=(B, MAX_LEN, cfg.d_model))
                .astype(np.float32),
                "bos": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)}
    n = S - cfg.n_frontend
    out = {"tokens": rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)}
    if cfg.n_frontend:
        out["frontend"] = rng.normal(size=(B, cfg.n_frontend, cfg.d_model)
                                     ).astype(np.float32)
    else:
        out["prompt_len"] = np.array([S, S - 7, S // 2, 7], np.int32)
    return out


def _reference(cfg, batch, n_decode=N_DECODE):
    """repro's prefill and greedy decode of ``cfg`` (a reduced repro
    config): per step the logits and the tokens, and the final cache."""
    jm = jget_model(cfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    cache = jm.init_cache(B, JShape("s", "decode", MAX_LEN, B))
    logits, cache = jax.jit(jm.prefill)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cache)
    decode = jax.jit(jm.decode)
    out = []
    for i in range(n_decode + 1):
        if i:
            logits, cache = decode(params, tok, cache)
        tok = jnp.argmax(logits[:, :cfg.vocab], -1).astype(jnp.int32)[:,
                                                                        None]
        out.append((np.asarray(logits), np.asarray(tok[:, 0])))
    return params, out, cache, jm


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)


def _port_leaves(tree, path=()):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {path: tree}
    return {p: t for k, v in items for p, t in _port_leaves(
        v, path + (k,)).items()}


def _serve_and_check(mesh, cfg, jcfg, batch, n_decode=N_DECODE):
    """Serve ``batch`` on the ranks and against ``repro``: tokens equal,
    logits within TOL and the same on every rank, every cache leaf
    assembled from the ranks' blocks by ``repro``'s specs of a fresh
    cache (a leaf's blocks laid as the port lays them) within TOL of
    ``repro``'s cache. ``repro``'s enc-dec cache ends with the source's
    cells of cross K/V: the port's leaf matches them and is zero past
    them. Returns the layouts' mesh axes."""
    jparams, ref, jcache, jm = _reference(jcfg, batch, n_decode)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    res = mesh.call(sr.serve, cfg, params,
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    n_decode, MAX_LEN)
    for i, (want, tok) in enumerate(ref):
        for out in res:
            assert torch.equal(out["logits"][i], res[0]["logits"][i])
            np.testing.assert_array_equal(out["tokens"][i].numpy(), tok,
                                          err_msg=f"step {i}")
        np.testing.assert_allclose(res[0]["logits"][i].numpy(), want,
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
    shape = JShape("s", "decode", MAX_LEN, B)
    specs, _ = jax.tree_util.tree_flatten_with_path(
        jm.cache_pspecs(jm.init_cache(B, shape), jmake_plan(jcfg, shape,
                                                            AMAP), AMAP),
        is_leaf=lambda x: isinstance(x, P))
    leaves = dict(jax.tree_util.tree_flatten_with_path(jcache)[0])
    ranks = [_port_leaves(out["cache"]) for out in res]
    sharded = set()
    for path, spec in specs:
        want = np.asarray(leaves[path], np.float32)
        key, spec = tuple(_key(k) for k in path), tuple(spec)
        whole = list(want.shape)
        if key[0].startswith("cross"):           # (L, B, S, Hk, dh)
            whole[2] = MAX_LEN
        full = torch.full(whole, float("nan"))
        for r, got in enumerate(ranks):
            assert tuple(got[key].shape) == partition.local_shape(
                whole, spec, AMAP), key
            partition.local_block(full, spec, AMAP,
                                  mesh.coords(r)).copy_(got[key].float())
        n = want.shape[2] if key[0].startswith("cross") else None
        np.testing.assert_allclose(full[:, :, :n].numpy() if n else
                                   full.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=str(key))
        if n:
            assert torch.equal(full[:, :, n:], torch.zeros_like(
                full[:, :, n:])), key
        sharded.update(e for e in spec if e)
    return sharded


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_equals_reference(mesh, arch):
    cfg = get_config(arch).reduced()
    sharded = _serve_and_check(mesh, cfg, JCONFIGS[arch].reduced(),
                               _batch(cfg, len(arch)))
    assert "model" in sharded and "data" in sharded


ENCDEC_SRC, ENCDEC_DECODE = 41, 14


def test_encdec_sequence_split_equals_reference(mesh):
    """An enc-dec whose 2 KV heads do not divide 'model' (4): the
    prefill splits the 41 source frames 10/10/10/11 over the ranks
    while the cross cache's 48 cells lie in blocks of 12 (rank 3 holds
    5 live cells), the self cache (48 cells, blocks of 12) crosses a
    block boundary while decoding, and every rank's self block but the
    first is empty at the BOS token."""
    arch = "seamless-m4t-medium"
    cfg = dataclasses.replace(get_config(arch).reduced(), n_kv_heads=2)
    jcfg = dataclasses.replace(JCONFIGS[arch].reduced(), n_kv_heads=2)
    rng = np.random.default_rng(7)
    batch = {"src_embeds": rng.normal(size=(B, ENCDEC_SRC, cfg.d_model))
             .astype(np.float32),
             "bos": rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)}
    sharded = _serve_and_check(mesh, cfg, jcfg, batch, ENCDEC_DECODE)
    assert "model" in sharded and "data" in sharded
