"""Rank-mesh builders (port of ``repro.launch.mesh`` and
``repro.compat.make_mesh``).

Each builder spawns the mesh's rank processes (``core.rank_mesh``), so
it is a function, never a module-level constant. The ranks run on the
card unless ``device="cpu"`` is given. The production mesh
(``make_production_mesh``) comes with the FSDP slice.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.rank_mesh import RankMesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None, *,
              local_backend: str = "gloo",
              timeout: float = 60.0) -> RankMesh:
    """A ``shape`` mesh of rank processes over ``axes``."""
    return RankMesh(shape, axes, device, local_backend=local_backend,
                    timeout=timeout)


def make_host_mesh(n: int = 1, axis: str = "data", device=None,
                   **kwargs) -> RankMesh:
    """A one-axis mesh of ``n`` ranks (tests, examples)."""
    return make_mesh((n,), (axis,), device, **kwargs)
