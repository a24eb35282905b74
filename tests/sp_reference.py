"""The reference side of the sequence-parallel train tests
(``test_torch_sp_train.py``, ``test_torch_sp_train_families.py``):
``repro``'s unsharded per-worker step (``value_and_grad`` and AdamW,
vmapped over the DiLoCo workers, microbatches averaged in fp32), the
batches they share with the port, the plan and the check that
assembles the ranks' blocks of a tree by ``repro``'s specs.

A sharding constraint does not change the math, so ``repro``'s values
for a sequence-parallel step are those of its unsharded step. A
process computes each of them once (the parameters by arch, the
compiled step by (arch, microbatches), the steps' values by their
inputs), and compiles them at XLA's backend optimization level 0: the
same operations, in half the compile time, which keeps the whole
tier-1 run's load down."""
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.models.registry import get_model as jget_model
from repro.optim.adamw import AdamW as JAdamW
from repro.sharding import partition as jpart
from repro_torch.convert import from_jax_params
from repro_torch.core.sync_engine import leaves_with_paths
from repro_torch.sharding import partition
from repro_torch.sharding.plans import ParallelismPlan

AMAP = {"pod": 2, "data": 2, "model": 2}
K = AMAP["pod"]
LR = 1e-3
COMBO = ("data", "model")
JIT = {"compiler_options": {"xla_backend_optimization_level": 0}}


def sp_plan(microbatches: int = 1, remat: bool = True) -> ParallelismPlan:
    """The multi-pod plan with sequence parallelism (``make_plan``'s rules
    for a model of more than 6e8 parameters: ``repro/sharding/plans.py``),
    given explicitly: ``make_plan`` replicates the reduced models."""
    return ParallelismPlan(
        diloco_axis="pod",
        rules=(("vocab", COMBO), ("heads", COMBO), ("ff", [COMBO, "data"]),
               ("experts", "model"), ("embed", None), ("layers", None)),
        batch_axes=("data",), seq_axis=None, remat=remat, n_workers=K,
        act_seq_axis="model", microbatches=microbatches)


@functools.cache
def ref_params(arch):
    """``repro``'s reduced parameters and the port's copy of them."""
    jm = jget_model(JCONFIGS[arch].reduced())
    params = jax.jit(lambda key: jm.init(key)[0], **JIT)(
        jax.random.PRNGKey(0))
    return params, from_jax_params(jax.tree.map(np.asarray, params), "cpu")


def batch(arch, rows: int, seq: int, *, seed: int = 1,
          random_mask: bool = True, src_len: int | None = None) -> dict:
    """A (K, rows, ...) numpy batch of ``arch``'s inputs: ``seq``
    positions of the residual stream (a VLM's frontend and tokens), an
    enc-dec's source of ``src_len`` frames; a random 0/1 mask, or ones."""
    cfg = JCONFIGS[arch].reduced()
    rng = np.random.default_rng(seed)
    n_tok = seq - cfg.n_frontend
    tok = rng.integers(0, cfg.vocab, (K, rows, n_tok + 1)).astype(np.int32)
    mask = (rng.random((K, rows, n_tok)) < 0.7) if random_mask \
        else np.ones((K, rows, n_tok))
    out = {"tokens": tok[..., :-1], "targets": tok[..., 1:],
           "mask": mask.astype(np.float32)}
    if cfg.n_frontend:
        out["frontend"] = rng.standard_normal(
            (K, rows, cfg.n_frontend, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = rng.standard_normal(
            (K, rows, src_len or seq, cfg.d_model)).astype(np.float32)
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _moe_dropped(jcfg, params, tokens):
    """``dropped_frac`` of ``repro``'s forward on ``tokens``: the mean
    over the MoE layers (the port's metric), layer by layer."""
    x = jcommon.embedding_lookup(params["embed"], tokens)
    b, s = tokens.shape
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    for i in range(jcfg.moe.first_dense):
        x, _, _ = jtf._layer(jcfg, params[f"dense{i}"], x, positions=pos,
                             is_moe=False)
    drops = []
    for l in range(params["layers"]["wq"].shape[0]):
        p = jax.tree.map(lambda a: a[l], params["layers"])
        x, _, aux = jtf._layer(jcfg, p, x, positions=pos, is_moe=True)
        drops.append(aux["dropped_frac"])
    return jnp.mean(jnp.stack(drops))


@functools.cache
def _ref_step(arch, nmb: int):
    """``repro``'s per-worker step, vmapped over the workers and jitted:
    microbatch i is rows [i B / n, (i + 1) B / n), gradients averaged in
    fp32, then AdamW; the metrics of the last microbatch (``dropped_frac``
    an MoE's, as the port reports it) and the gradient."""
    jcfg = JCONFIGS[arch].reduced()
    jm = jget_model(jcfg)
    opt = JAdamW(lr=LR)

    def grad(p, bb):
        rows = bb["tokens"].shape[0] // nmb
        acc = jax.tree.map(jnp.zeros_like, p)
        for i in range(nmb):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in bb.items()}
            (_, m), g = jax.value_and_grad(jm.loss, has_aux=True)(p, mb)
            acc = jax.tree.map(jnp.add, acc, g)
        if jcfg.moe is not None:
            m = dict(m, dropped_frac=_moe_dropped(jcfg, p, mb["tokens"]))
        return jax.tree.map(lambda g: g / nmb, acc), m

    @functools.partial(jax.jit, **JIT)
    def step(p, st, bb):
        g, m = jax.vmap(grad)(p, bb)
        p, st = jax.vmap(opt.update)(g, st, p)
        return p, st, m, g
    return step, opt


_STEPS: dict = {}


def ref_steps(arch, params, b: dict, n_steps: int, nmb: int = 1):
    """``repro``'s per-worker step (``_ref_step``) run ``n_steps`` times
    on each worker's batch of ``b`` from ``params`` (``ref_params(arch)``'s).
    Returns each step's metrics, {name: (K, n_steps)}, and the first
    step's gradient, stacked (K, ...) over the workers."""
    digest = hashlib.sha256()
    for k in sorted(b):
        digest.update(k.encode() + str(b[k].shape).encode() + b[k].tobytes())
    key = (arch, n_steps, nmb, digest.hexdigest())
    if key in _STEPS:
        return _STEPS[key]
    step, opt = _ref_step(arch, nmb)
    p = jax.tree.map(lambda x: jnp.stack([x] * K), params)
    st = jax.vmap(opt.init)(p)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    hist, first = [], None
    for _ in range(n_steps):
        p, st, m, g = step(p, st, jb)
        hist.append({k: np.asarray(v) for k, v in m.items()})
        first = g if first is None else first
    metrics = {k: np.stack([h[k] for h in hist], 1) for k in hist[0]}
    _STEPS[key] = metrics, jax.tree.map(np.asarray, first)
    return _STEPS[key]


def ref_specs(arch, plan):
    """``repro``'s parameter specs for ``plan`` on ``AMAP``, as tuples."""
    jm = jget_model(JCONFIGS[arch].reduced())
    shapes, axes = jcommon.eval_axes(jm.init, jax.random.PRNGKey(0))
    return jax.tree.map(
        tuple, jpart.param_pspecs(axes, shapes, plan, AMAP),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def assert_metrics(res, mesh, want: dict, tol: float = 1e-4) -> None:
    """Every rank's metrics of every step against ``want`` ({name: (K,
    n_steps)}) of its worker; the port reports each of ``want``'s."""
    for r, out in enumerate(res):
        w = mesh.coords(r)["pod"]
        for k, v in want.items():
            got = [m[k] for m in out["metrics"]]
            np.testing.assert_allclose(got, v[w], rtol=tol, atol=tol,
                                       err_msg=f"rank {r} {k}")


def assert_every_leaf(res, mesh, key, want, specs, tol: float) -> None:
    """Every (K, ...) leaf of ``key``, assembled from the ranks' local
    blocks (each rank's block written where ``partition.local_block``
    cuts worker ``pod``'s leaf by ``repro``'s spec), against ``want``
    (stacked over the workers). A block no rank wrote stays NaN and
    fails."""
    for path, _ in leaves_with_paths(res[0][key]):
        ref = np.asarray(_at(want, path), np.float32)
        full = torch.full(ref.shape, float("nan"))
        for r in range(mesh.size):
            c = mesh.coords(r)
            partition.local_block(full[c["pod"]], _at(specs, path), AMAP,
                                  c).copy_(_at(res[r][key], path)[0])
        np.testing.assert_allclose(full.numpy(), ref, rtol=tol, atol=tol,
                                   err_msg=f"{key} {path}")
