"""Meshes (port of ``repro.launch.mesh`` and
``repro.compat.make_mesh``).

``make_mesh`` / ``make_host_mesh`` spawn a mesh of rank processes
(``core.rank_mesh``), so they are functions, never module-level
constants; the ranks run on the card unless ``device="cpu"`` is given.
Inside a rank, ``RankContext.device_mesh()`` is the ``DeviceMesh`` over
the ranks' world that the FSDP train step and its sharded outer sync
run on.

``make_production_mesh`` is the production mesh of the dry run: a
``DeviceMesh`` over an in-process FAKE world (torch's ``fake`` process
group backend), where this process is one rank of 256 or 512 (rank 0,
or the rank a cell traces) and every collective returns at once without
moving data. It is the counterpart
of the reference's ``--xla_force_host_platform_device_count=512``
placeholder devices: enough to trace one rank's step on fake tensors
(``analysis.op_cost``), nothing to run.

Single pod: (16, 16) = (data, model), 256 ranks. Multi-pod: (2, 16, 16)
= (pod, data, model), 512 ranks; the 'pod' axis is the DiLoCo axis.
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


def fake_world(world_size: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake world of ``world_size``
    ranks (once per process: a second call must ask for the same)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise RuntimeError(f"this process is rank {dist.get_rank()} of "
                               f"{dist.get_world_size()}, not {rank} of "
                               f"{world_size}")
        return
    # torch's fake process group lives in its testing package; this is
    # the one place the port imports it
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_fake_mesh(shape: Sequence[int], axes: Sequence[str],
                   rank: int = 0):
    """A CPU ``DeviceMesh`` of ``shape`` over ``axes`` in a fake world of
    prod(shape) ranks, this process rank ``rank`` (row-major). Build it
    outside ``FakeTensorMode``: the mesh holds a real rank tensor."""
    import math
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    fake_world(n, rank)
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes, rank)
