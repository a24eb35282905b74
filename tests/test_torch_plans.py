"""The port's parallelism plans and layouts (``repro_torch.sharding``,
``ModelDef.axes`` / ``input_specs``, ``analysis.roofline.
model_flops_for``) against ``repro``'s: every output is discrete, so
each must be equal, for all 11 configs x 4 shapes x both production axis
maps. Also ``ModelDef.cache_pspecs`` for every config x serve shape x
axis map on ``meta`` caches, the reference's ``tests/test_partition.py``
cases on the port's functions, and the DTensor placements of a spec."""
import dataclasses

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.analysis import roofline as jroof
from repro.configs import CONFIGS as JCONFIGS
from repro.configs import SHAPES as JSHAPES
from repro.models import common as jcommon
from repro.models.registry import get_model as jget_model
from repro.sharding import make_plan as jmake_plan
from repro.sharding import partition as jpart
from repro_torch.analysis import roofline as troof
from repro_torch.configs import CONFIGS, SHAPES
from repro_torch.models.registry import get_model
from repro_torch.sharding import partition
from repro_torch.sharding.plans import make_plan

MESH_S = {"data": 16, "model": 16}
MESH_M = {"pod": 2, "data": 16, "model": 16}
ARCHS = sorted(CONFIGS)


def _specs(tree):
    """A PartitionSpec tree as the port's tuples."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@pytest.fixture(scope="module")
def ref_axes():
    """repro's (shapes, axes) of every config, traced once."""
    return {a: jcommon.eval_axes(jget_model(JCONFIGS[a]).init,
                                 jax.random.PRNGKey(0)) for a in ARCHS}


@pytest.mark.parametrize("mesh", [MESH_S, MESH_M], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_plan_equals_reference(arch, mesh):
    for shape in SHAPES:
        got = make_plan(CONFIGS[arch], SHAPES[shape], mesh)
        want = jmake_plan(JCONFIGS[arch], JSHAPES[shape], mesh)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), shape


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_equal_reference(arch, ref_axes):
    shapes, axes = ref_axes[arch]
    model = get_model(CONFIGS[arch], device="meta")
    assert model.axes() == axes
    got = jax.tree.map(lambda t: tuple(t.shape), model.param_shapes())
    assert got == jax.tree.map(lambda s: tuple(s.shape), shapes)


@pytest.mark.parametrize("mesh", [MESH_S, MESH_M], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_batch_specs_equal_reference(arch, mesh, ref_axes):
    shapes, axes = ref_axes[arch]
    model = get_model(CONFIGS[arch], device="meta")
    for shape in SHAPES:
        plan = make_plan(CONFIGS[arch], SHAPES[shape], mesh)
        jplan = jmake_plan(JCONFIGS[arch], JSHAPES[shape], mesh)
        got = partition.param_pspecs(model.axes(), model.param_shapes(),
                                     plan, mesh)
        assert got == _specs(jpart.param_pspecs(axes, shapes, jplan, mesh))
        for dax in (None, "pod", "data"):
            assert partition.with_leading(got, dax) == _specs(
                jpart.with_leading(jpart.param_pspecs(axes, shapes, jplan,
                                                      mesh), dax))
        for b in (None, 1, 7, 32, 128, 256):
            assert partition.batch_pspec(plan, b, mesh) == tuple(
                jpart.batch_pspec(jplan, b, mesh)), (shape, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspec_equals_reference(arch):
    cfg = CONFIGS[arch]
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    for mesh in (MESH_S, MESH_M):
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            plan = make_plan(cfg, SHAPES[shape], mesh)
            jplan = jmake_plan(JCONFIGS[arch], JSHAPES[shape], mesh)
            b, s = SHAPES[shape].global_batch, SHAPES[shape].seq_len
            for leaf, dims in (((cfg.n_layers, b, s, cfg.n_kv_heads, hd),
                                (1, 3, 2)),
                               ((b, s, cfg.n_kv_heads, hd), (0, 2, 1)),
                               ((cfg.n_layers, b, 24, 64, 128),
                                (1, 2, None))):
                kw = dict(batch_dim=dims[0], heads_dim=dims[1],
                          seq_dim=dims[2])
                assert partition.cache_pspec(leaf, plan, mesh, **kw) == \
                    tuple(jpart.cache_pspec(leaf, jplan, mesh, **kw))


def _port_leaves(tree, path=()):
    """{path: spec} of the port's cache spec tree (dict keys, list
    indices, dataclass and named-tuple fields; None holds nothing)."""
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
    return {p: s for k, v in items for p, s in _port_leaves(
        v, path + (k,)).items()}


def _ref_leaves(tree):
    """{path: spec} of ``repro``'s cache spec tree, with the port's path
    keys."""
    def key(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return getattr(k, attr)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(key(k) for k in path): tuple(spec) for path, spec in flat}


@pytest.mark.parametrize("mesh", [MESH_S, MESH_M], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_reference(arch, mesh):
    """Every leaf of every serve cell's cache, on ``meta`` caches."""
    model = get_model(CONFIGS[arch], device="meta")
    jm = jget_model(JCONFIGS[arch])
    for name in ("prefill_32k", "decode_32k", "long_500k"):
        shape, b = SHAPES[name], SHAPES[name].global_batch
        plan = make_plan(CONFIGS[arch], shape, mesh)
        jplan = jmake_plan(JCONFIGS[arch], JSHAPES[name], mesh)
        got = _port_leaves(model.cache_pspecs(
            model.init_cache(b, shape, device="meta"), plan, mesh))
        jcache = jax.eval_shape(lambda: jm.init_cache(b, JSHAPES[name]))
        want = _ref_leaves(jm.cache_pspecs(jcache, jplan, mesh))
        assert got == want, name
        assert any(s for s in got.values()), name


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    model = get_model(CONFIGS[arch], device="meta")
    jmodel = jget_model(JCONFIGS[arch])
    for shape in SHAPES:
        got, want = model.input_specs(SHAPES[shape]), \
            jmodel.input_specs(JSHAPES[shape])
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (shape, k)
            assert str(got[k].dtype) == "torch." + str(want[k].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    for shape in SHAPES:
        assert troof.model_flops_for(CONFIGS[arch], SHAPES[shape]) == \
            jroof.model_flops_for(JCONFIGS[arch], JSHAPES[shape])


# -- the reference's tests/test_partition.py cases, on the port ---------------


def _granite_train():
    return make_plan(CONFIGS["granite-3-2b"], SHAPES["train_4k"], MESH_S)


def _case_diloco_axis():
    cfg = CONFIGS["granite-3-2b"]
    assert make_plan(cfg, SHAPES["train_4k"], MESH_S).diloco_axis == "data"
    assert make_plan(cfg, SHAPES["train_4k"], MESH_M).diloco_axis == "pod"
    dbrx = CONFIGS["dbrx-132b"]
    assert make_plan(dbrx, SHAPES["train_4k"], MESH_S).diloco_axis is None
    assert make_plan(dbrx, SHAPES["train_4k"], MESH_M).diloco_axis == "pod"
    assert make_plan(cfg, SHAPES["decode_32k"], MESH_M).diloco_axis is None


def _case_inner_dp():
    plan = make_plan(CONFIGS["mamba2-130m"], SHAPES["train_4k"], MESH_S)
    assert all(ax is None for _, ax in plan.rules)
    assert "model" in plan.batch_axes


def _case_rules_and_conflicts():
    plan = _granite_train()
    assert partition.param_pspec(("vocab", "embed"), (49408, 2048), plan,
                                 MESH_S) == ("model",)
    assert partition.param_pspec(("embed", "ff"), (2048, 8192), plan,
                                 MESH_S) == (None, "model")
    assert partition.param_pspec(("experts", "embed", "ff"),
                                 (64, 2048, 1408), plan,
                                 MESH_S) == ("model",)


def _case_divisibility_guard():
    assert partition.param_pspec(("heads",), (24,), _granite_train(),
                                 MESH_S) == ()


def _case_batch_fallback():
    plan = make_plan(CONFIGS["granite-3-2b"], SHAPES["decode_32k"], MESH_M)
    assert partition.batch_pspec(plan, 128, MESH_M) != ()
    assert partition.batch_pspec(plan, 1, MESH_M) == ()


def _case_cache_heads_vs_seq():
    plan = make_plan(CONFIGS["internlm2-1.8b"], SHAPES["decode_32k"],
                     MESH_S)
    assert partition.cache_pspec((24, 128, 32768, 8, 128), plan, MESH_S,
                                 batch_dim=1, heads_dim=3, seq_dim=2) == \
        (None, "data", "model")
    plan2 = make_plan(CONFIGS["phi-3-vision-4.2b"], SHAPES["decode_32k"],
                      MESH_S)
    assert partition.cache_pspec((32, 128, 32768, 32, 96), plan2, MESH_S,
                                 batch_dim=1, heads_dim=3, seq_dim=2) == \
        (None, "data", None, "model")


def _case_remat():
    for arch in ("mamba2-130m", "dbrx-132b"):
        assert make_plan(CONFIGS[arch], SHAPES["train_4k"], MESH_S).remat
        assert not make_plan(CONFIGS[arch], SHAPES["decode_32k"],
                             MESH_S).remat


def _case_vocab_padding():
    for cfg in CONFIGS.values():
        assert cfg.padded_vocab % 256 == 0
        assert cfg.vocab <= cfg.padded_vocab < cfg.vocab + 256


@pytest.mark.parametrize("case", [
    _case_diloco_axis, _case_inner_dp, _case_rules_and_conflicts,
    _case_divisibility_guard, _case_batch_fallback,
    _case_cache_heads_vs_seq, _case_remat, _case_vocab_padding],
    ids=lambda f: f.__name__[6:])
def test_partition_cases(case):
    case()


def test_local_shape_and_block():
    import torch
    amap = {"pod": 2, "data": 4, "model": 2}
    spec = (("data", "model"), None, "pod")
    assert partition.local_shape((16, 3, 4), spec, amap) == (2, 3, 2)
    x = torch.arange(16 * 3 * 4).reshape(16, 3, 4)
    blk = partition.local_block(x, spec, amap, {"pod": 1, "data": 2,
                                                "model": 1})
    # combined entry: row-major over (data, model) -> index 2 * 2 + 1
    assert torch.equal(blk, x[10:12, :, 2:4])
    with pytest.raises(ValueError):
        partition.local_shape((15, 3, 4), spec, amap)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:                     # only the names matter
        mesh_dim_names = ("data", "model")

    assert partition.placements(("model",), Mesh()) == (Replicate(),
                                                        Shard(0))
    assert partition.placements(("data", "model"), Mesh()) == (Shard(0),
                                                               Shard(1))
    assert partition.placements((None, ("data", "model")), Mesh()) == \
        (Shard(1), Shard(1))
    assert partition.placements((), Mesh()) == (Replicate(), Replicate())

    class Flat:
        mesh_dim_names = ("data_model",)
    assert partition.placements((("data", "model"),), Flat()) == \
        (Shard(0),)
    with pytest.raises(ValueError):
        partition.placements(("pod",), Mesh())
