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
  * seamless-m4t-medium: the self and cross caches by heads;
  * mamba2-130m, zamba2-2.7b: SSM states by heads, conv rings by
    channels, zamba2's shared-attention KV by heads.

Every case: greedy tokens equal ``repro``'s; logits within 1e-4 (the
families' parity tolerance) and the same on every rank; every cache
leaf, assembled from the ranks' blocks by ``repro``'s specs, within 1e-4
of ``repro``'s cache, each rank holding exactly ``local_shape`` of its
spec. An enc-dec whose heads do not divide 'model' is refused.
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


def _reference(arch, batch):
    """repro's prefill and greedy decode: per step the logits and the
    tokens, and the final cache."""
    cfg = JCONFIGS[arch].reduced()
    jm = jget_model(cfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    cache = jm.init_cache(B, JShape("s", "decode", MAX_LEN, B))
    logits, cache = jax.jit(jm.prefill)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cache)
    decode = jax.jit(jm.decode)
    out = []
    for i in range(N_DECODE + 1):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_equals_reference(mesh, arch):
    cfg = get_config(arch).reduced()
    batch = _batch(cfg, len(arch))
    jparams, ref, jcache, jm = _reference(arch, batch)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    res = mesh.call(sr.serve, cfg, params,
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    N_DECODE, MAX_LEN)
    for i, (want, tok) in enumerate(ref):
        for out in res:
            assert torch.equal(out["logits"][i], res[0]["logits"][i])
            np.testing.assert_array_equal(out["tokens"][i].numpy(), tok,
                                          err_msg=f"step {i}")
        np.testing.assert_allclose(res[0]["logits"][i].numpy(), want,
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")
    # the cache: repro's leaves, laid out by repro's specs
    jplan = jmake_plan(JCONFIGS[arch].reduced(),
                       JShape("s", "decode", MAX_LEN, B), AMAP)
    specs, _ = jax.tree_util.tree_flatten_with_path(
        jm.cache_pspecs(jcache, jplan, AMAP),
        is_leaf=lambda x: isinstance(x, P))
    leaves = dict(jax.tree_util.tree_flatten_with_path(jcache)[0])
    ranks = [_port_leaves(out["cache"]) for out in res]
    sharded = set()
    for path, spec in specs:
        want = np.asarray(leaves[path], np.float32)
        key, spec = tuple(_key(k) for k in path), tuple(spec)
        full = torch.full(want.shape, float("nan"))
        for r, got in enumerate(ranks):
            assert tuple(got[key].shape) == partition.local_shape(
                want.shape, spec, AMAP), key
            partition.local_block(full, spec, AMAP,
                                  mesh.coords(r)).copy_(got[key].float())
        np.testing.assert_allclose(full.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=str(key))
        sharded.update(e for e in spec if e)
    assert "model" in sharded and "data" in sharded


def test_encdec_sequence_split_raises(mesh):
    cfg = dataclasses.replace(get_config("seamless-m4t-medium").reduced(),
                              n_kv_heads=2)
    assert mesh.call(sr.encdec_split_raises, cfg) == [True] * mesh.size
