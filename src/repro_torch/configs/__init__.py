"""Config registry (port of ``repro.configs``): ``get_config(arch_id)``
+ the assigned-arch list."""
from repro_torch.configs import (base, dbrx_132b, deepseek_moe_16b,
                                 granite_3_2b, h2o_danube_1_8b,
                                 intellect_1, internlm2_1_8b, mamba2_130m,
                                 minicpm_2b, phi_3_vision_4_2b,
                                 seamless_m4t_medium, zamba2_2_7b)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

_MODULES = [seamless_m4t_medium, internlm2_1_8b, h2o_danube_1_8b,
            minicpm_2b, granite_3_2b, deepseek_moe_16b, dbrx_132b,
            phi_3_vision_4_2b, zamba2_2_7b, mamba2_130m, intellect_1]

CONFIGS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG
                                  for m in _MODULES}
ASSIGNED: tuple[str, ...] = tuple(m.CONFIG.name for m in _MODULES[:10])


def get_config(name: str) -> ArchConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(CONFIGS)}")
    return CONFIGS[name]


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "CONFIGS", "ASSIGNED",
           "get_config"]
