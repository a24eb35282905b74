"""repro_torch's DiLoCo pieces against repro on the same numpy-seeded
inputs: the outer sync (flatten order, int8 ring, flat Nesterov step),
the inner and outer optimizers, the LR schedule, and the training loss
with its gradients on the reduced INTELLECT-1 (fp32).

Tolerances: optimizers rtol 1e-6 (the same fp32 arithmetic; pow and
sqrt may differ by an ulp); loss and metrics rtol 1e-5, gradients
rtol 1e-4 with atol 1e-5 of the leaf's largest gradient (sums
with cancellation, taken in another order); the outer sync's
anchor and momentum under the ring test's int8 tolerance, scaled by the
outer step (anchor' = anchor - lr (1 + mu) delta from zero momentum)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.core import diloco as jdl
from repro.core.sync_engine import SyncEngine as JSyncEngine
from repro.models import common as jcommon
from repro.models.registry import get_model as jget_model
from repro.optim import schedules as jsched
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.nesterov import NesterovSGD as JNesterov
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.convert import from_jax_params
from repro_torch.core import diloco as tdl
from repro_torch.core.sync_engine import SyncEngine as TSyncEngine
from repro_torch.core.sync_engine import leaves, tree_map
from repro_torch.models import common as tcommon
from repro_torch.models.registry import get_model as tget_model
from repro_torch.optim import schedules as tsched
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.nesterov import NesterovSGD as TNesterov
from test_torch_ring import check_ring_close, int8_bound

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)

ARCH = "intellect-1"


@pytest.fixture(scope="module")
def reduced():
    jm = jget_model(JCONFIGS[ARCH].reduced())
    params, _ = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    tm = tget_model(TCONFIGS[ARCH].reduced(), "cpu")
    return jm, np_params, tm


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(5, 7)).astype(dtype),
            "b": {"z": rng.normal(size=(7,)).astype(dtype),
                  "a": rng.normal(size=(3, 2, 4)).astype(dtype)}}


def _close_trees(t, j, rtol, atol=0.0):
    tl, jl = leaves(t), jax.tree.leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=rtol, atol=atol)


def test_flatten_order_is_jax_sorted_key_order(reduced):
    _, np_params, _ = reduced
    want = np.asarray(JSyncEngine.for_tree(np_params).flatten(
        jax.tree.map(jnp.asarray, np_params)))
    tp = from_jax_params(np_params, "cpu")
    eng = TSyncEngine.for_tree(tp)
    flat = eng.flatten(tp)
    np.testing.assert_array_equal(flat.numpy(), want)
    back = eng.unflatten(flat, like=tp)
    for a, b in zip(leaves(back), leaves(tp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("lr", ["const", "wsd"])
def test_adamw_matches_reference(steps, lr):
    p, tp = _tree(0), from_jax_params(_tree(0), "cpu")
    jopt = JAdamW(lr=1e-2 if lr == "const" else jsched.wsd(1e-2, 3, 12))
    topt = TAdamW(lr=1e-2 if lr == "const" else tsched.wsd(1e-2, 3, 12))
    js, ts = jopt.init(p), topt.init(tp)
    jp = jax.tree.map(jnp.asarray, p)
    # the in-place form (the trainer's) must agree with the functional one
    ip, ist = tree_map(torch.clone, tp), topt.init(tp)
    for i in range(steps):
        g = _tree(100 + i)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tg = from_jax_params(g, "cpu")
        tp, ts = topt.update(tg, ts, tp)
        topt.update_(tg, ist, ip)
    _close_trees(tp, jp, rtol=1e-6, atol=1e-7)
    _close_trees(ts.m, js.m, rtol=1e-6, atol=1e-7)
    _close_trees(ts.v, js.v, rtol=1e-6, atol=1e-9)
    assert int(ts.step) == int(js.step) == int(ist.step) == steps
    for a, b in zip(leaves(ip), leaves(tp)):
        assert torch.equal(a, b)


def test_adamw_bf16_params_round_like_reference():
    """fp32 arithmetic, then a cast to the parameter dtype (bf16)."""
    import ml_dtypes
    p = _tree(1, ml_dtypes.bfloat16)
    jopt, topt = JAdamW(lr=3e-2), TAdamW(lr=3e-2)
    jp, js = jax.tree.map(jnp.asarray, p), None
    js = jopt.init(jp)
    tp = from_jax_params(p, "cpu")
    ts = topt.init(tp)
    for i in range(3):
        g = _tree(200 + i)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(from_jax_params(g, "cpu"), ts, tp)
    assert all(t.dtype == torch.bfloat16 for t in leaves(tp))
    _close_trees(tp, jp, rtol=0.0)


@pytest.mark.parametrize("steps", [1, 10])
def test_nesterov_matches_reference(steps):
    jopt, topt = JNesterov(), TNesterov()
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = from_jax_params(_tree(0), "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    jf = jnp.asarray(np.concatenate([np.ravel(x) for x in
                                     jax.tree.leaves(_tree(0))]))
    tf, tm = torch.tensor(np.asarray(jf)), torch.zeros(jf.shape[0])
    jm = jnp.zeros_like(jf)
    for i in range(steps):
        d = _tree(300 + i)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, d), js, jp)
        tp, ts = topt.update(from_jax_params(d, "cpu"), ts, tp)
        df = np.concatenate([np.ravel(x) for x in jax.tree.leaves(d)])
        jf, jm = jopt.update_flat(jnp.asarray(df), jm, jf)
        tf, tm = topt.update_flat(torch.from_numpy(df), tm, tf)
    _close_trees(tp, jp, rtol=1e-6, atol=1e-7)
    _close_trees(ts.momentum, js.momentum, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-7)


def test_wsd_schedule_matches_reference():
    for shape in ["one_minus_sqrt", "linear", "cosine"]:
        j = jsched.wsd(1e-3, 10, 100, decay_shape=shape, final_ratio=0.1)
        t = tsched.wsd(1e-3, 10, 100, decay_shape=shape, final_ratio=0.1)
        for step in [0, 1, 5, 10, 50, 80, 81, 99, 100, 150]:
            np.testing.assert_allclose(float(t(step)), float(j(step)),
                                       rtol=1e-6)
    assert float(tsched.constant(0.5)(3)) == float(jsched.constant(0.5)(3))


def test_cross_entropy_max_z_matches_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(2, 9, 50))).astype(np.float32)
    targets = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    mask = (rng.uniform(size=(2, 9)) > 0.3).astype(np.float32)
    for m in (None, mask):
        jl, jmet = jcommon.cross_entropy_max_z(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m))
        tl, tmet = tcommon.cross_entropy_max_z(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        for key in ("ce", "z", "loss"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-5)


def test_loss_and_grads_match_reference(reduced):
    jm, np_params, tm = reduced
    cfg = TCONFIGS[ARCH].reduced()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": (rng.uniform(size=(2, 16)) > 0.1).astype(np.float32)}
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jax.tree.map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree_map(lambda x: x.requires_grad_(True),
                  from_jax_params(np_params, "cpu"))
    tl, tmet = tm.loss(tp, {k: torch.from_numpy(v) for k, v in
                            batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for key in ("ce", "z", "loss"):
        np.testing.assert_allclose(float(tmet[key].detach()), float(jmet[key]),
                                   rtol=1e-5)
    for a, b in zip(leaves(tree_map(lambda x: x.grad, tp)),
                    jax.tree.leaves(jg)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(_np(a), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("quant", ["int8", "fp32"])
def test_outer_sync_sim_matches_reference(reduced, k, quant):
    _, np_params, _ = reduced
    rng = np.random.default_rng(k)
    stacked = jax.tree.map(
        lambda p: (p[None] + 0.01 * rng.normal(size=(k,) + p.shape))
        .astype(np.float32), np_params)
    weights = np.ones((k,), np.float32)
    weights[-1] = 0.0 if k > 2 else 1.0
    order = tuple(range(k))[::-1]
    jcfg = jdl.DiLoCoConfig(quant=quant)
    jst = jdl.init_outer_state_sim(jax.tree.map(jnp.asarray, np_params),
                                   jcfg, k)
    jnew, jst2 = jdl.outer_sync_sim(jax.tree.map(jnp.asarray, stacked),
                                    jst, jcfg, ring_order=order,
                                    weights=jnp.asarray(weights))
    tcfg = tdl.DiLoCoConfig(quant=quant)
    tst = tdl.init_outer_state_sim(from_jax_params(np_params, "cpu"),
                                   tcfg, k)
    tstacked = from_jax_params(stacked, "cpu")
    tnew, tst2 = tdl.outer_sync_sim(tstacked, tst, tcfg, ring_order=order,
                                    weights=torch.from_numpy(weights))
    assert tst2.outer_step == int(jst2.outer_step) == 1
    eng = JSyncEngine.for_tree(jst2.anchor)
    a_flat = np.asarray(jst.anchor_flat)
    xs = a_flat[None] - np.stack([
        np.asarray(eng.flatten(jax.tree.map(lambda p: p[i], stacked)))
        for i in range(k)])
    bound = int8_bound(xs, weights, k)
    lr, mu = jcfg.outer_lr, jcfg.outer_momentum
    check_ring_close(tst2.anchor_flat.numpy(), jst2.anchor_flat, quant,
                     lr * (1 + mu) * bound)
    check_ring_close(TSyncEngine.for_tree(tst2.opt.momentum).flatten(
        tst2.opt.momentum).numpy(), eng.flatten(jst2.opt.momentum), quant,
        bound)
    # the anchor tree is a view of the flat anchor; every worker resets
    for leaf in leaves(tst2.anchor):
        assert leaf.untyped_storage().data_ptr() == \
            tst2.anchor_flat.untyped_storage().data_ptr()
    for a, s in zip(leaves(tst2.anchor), leaves(tnew)):
        assert s.shape[0] == k and torch.equal(s[k - 1], a)
    n = sum(x.size for x in jax.tree.leaves(np_params))
    assert tdl.sync_wire_bytes(from_jax_params(np_params, "cpu"), k,
                               tcfg) == \
        jdl.sync_wire_bytes(np_params, k, jcfg)
    assert tdl.bandwidth_reduction_factor(tcfg) == \
        jdl.bandwidth_reduction_factor(jcfg)
    assert n == TSyncEngine.for_tree(tst2.anchor).numel
