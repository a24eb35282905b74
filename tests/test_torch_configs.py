"""repro_torch.configs against repro.configs: every architecture's config,
its reduced sibling and the derived properties agree field for field."""
import dataclasses

import pytest
import torch

from repro import configs as jcfg
from repro_torch import configs as tcfg

torch.set_float32_matmul_precision("highest")
torch.use_deterministic_algorithms(True)
torch.set_num_threads(2)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_registry_lists_agree():
    assert list(tcfg.CONFIGS) == list(jcfg.CONFIGS)
    assert tcfg.ASSIGNED == jcfg.ASSIGNED
    assert ({k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()})


@pytest.mark.parametrize("name", list(jcfg.CONFIGS))
def test_config_matches_reference(name):
    j, t = jcfg.get_config(name), tcfg.get_config(name)
    for a, b in ((j, t), (j.reduced(), t.reduced())):
        assert _fields(a) == _fields(b)
        assert a.padded_vocab == b.padded_vocab
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert a.sub_quadratic == b.sub_quadratic
        for shape in jcfg.SHAPES.values():
            assert a.supports(shape) == b.supports(
                tcfg.SHAPES[shape.name])


def test_torch_dtype_and_unknown_arch():
    cfg = tcfg.get_config("intellect-1")
    assert cfg.torch_dtype == torch.bfloat16
    assert cfg.reduced().torch_dtype == torch.float32
    with pytest.raises(KeyError):
        tcfg.get_config("no-such-arch")
