"""ElasticDeviceMesh (port of ``repro.core.elastic_mesh``; INTELLECT-1
§2.4, Fig. 1).

The paper's ElasticDeviceMesh gives every process a *local* rank (the
FSDP group, fast intra-node fabric) and a *global* rank (the fault-
tolerant DiLoCo data-parallel group over the internet). Here the mesh
is a ``core.rank_mesh.RankMesh`` of rank processes:

  * the **mesh axes** play the roles of the process groups: the DiLoCo
    axis is the global group (its groups are gloo, as PRIME's global
    group is), the remaining axes the local groups (their backend is the
    mesh's ``local_backend``);
  * elasticity happens at outer-step boundaries, two ways:
      - **mask and renormalize** inside a fixed-capacity mesh: every
        DiLoCo slot has a weight in {0, 1}; dead, empty and joining
        slots weigh 0 and the ring average divides by the live weight
        sum (the paper's "join with zero pseudo-gradient" and "exclude
        failed nodes");
      - **remesh**: close the rank pool and re-form it at another DiLoCo
        size, through a new store and a new rendezvous (the paper's
        process-group re-init cost);
  * node ids (stable across the run, the paper's global ranks) map to
    mesh slots through ``SlotAssignment``; a node that dies frees its
    slot.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class SlotAssignment:
    """Stable node-id -> DiLoCo-slot mapping with free-list reuse."""

    capacity: int
    slot_of: dict[int, int] = dataclasses.field(default_factory=dict)

    def assign(self, node_id: int) -> int:
        if node_id in self.slot_of:
            return self.slot_of[node_id]
        used = set(self.slot_of.values())
        for s in range(self.capacity):
            if s not in used:
                self.slot_of[node_id] = s
                return s
        raise RuntimeError("ElasticDeviceMesh at capacity; "
                           "remesh with a larger DiLoCo axis")

    def release(self, node_id: int) -> None:
        self.slot_of.pop(node_id, None)

    def live_mask(self, live_ids, zero_weight_ids=()) -> np.ndarray:
        mask = np.zeros((self.capacity,), np.float32)
        for nid in live_ids:
            if nid in self.slot_of and nid not in zero_weight_ids:
                mask[self.slot_of[nid]] = 1.0
        return mask


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """The paper's ElasticDeviceMesh split of the outer sync: the WAN
    ring runs ONLY across the DiLoCo axis (one leader stream per site),
    while the remaining mesh axes form the fast intra-node group. The
    distributed sync (``train.step.DistSyncPrograms``) rings each rank's
    1/n_local slice over ``wan_axis`` and rebuilds the full vector with
    an intra-node all-gather — per-rank WAN bytes drop by ``n_local``.
    ``local_rank`` ordering matches :meth:`ElasticDeviceMesh.local_rank`
    (row-major over the non-DiLoCo axes), which is also the order the
    all-gather over ``local_axes`` concatenates."""

    wan_axis: str
    local_axes: tuple[str, ...]
    n_local: int

    @property
    def split(self) -> bool:
        """True when there is an intra-node group to split over."""
        return self.n_local > 1


def hierarchy(mesh, diloco_axis: str) -> HierarchySpec:
    """WAN/intra-node split of ``mesh`` around the DiLoCo axis."""
    local = tuple(a for a in mesh.axis_names if a != diloco_axis)
    n_local = math.prod(mesh.shape[a] for a in local)
    return HierarchySpec(diloco_axis, local, int(n_local))


class ElasticDeviceMesh:
    """Fixed-capacity rank mesh + slot assignment + weight computation."""

    def __init__(self, mesh, diloco_axis: str | None):
        self.mesh = mesh
        self.diloco_axis = diloco_axis
        cap = (mesh.shape[diloco_axis] if diloco_axis else 1)
        self.slots = SlotAssignment(cap)

    @property
    def capacity(self) -> int:
        return self.slots.capacity

    def admit(self, node_id: int) -> int:
        return self.slots.assign(node_id)

    def evict(self, node_id: int) -> None:
        self.slots.release(node_id)

    def weights(self, live_ids, joining_ids=(),
                straggler_ids=()) -> torch.Tensor:
        """Per-slot ring weights on the controller's device: 1 for
        contributing workers, 0 for joiners (zero pseudo-gradient),
        stragglers (excluded this round) and empty slots."""
        zero = set(joining_ids) | set(straggler_ids)
        return torch.as_tensor(self.slots.live_mask(live_ids, zero),
                               device=self.mesh.device)

    # -- rank bookkeeping (paper Fig. 1) -------------------------------------

    def global_rank(self, device_coords: dict[str, int]) -> int:
        """DiLoCo data-parallel rank of a mesh position."""
        return device_coords.get(self.diloco_axis, 0)

    def local_rank(self, device_coords: dict[str, int]) -> int:
        """FSDP-group rank of a mesh position (row-major over the
        non-DiLoCo axes)."""
        from repro_torch.core.rank_mesh import axes_index
        return axes_index(self.mesh.shape, [
            a for a in self.mesh.shape if a != self.diloco_axis],
            device_coords)

    # -- remesh path ----------------------------------------------------------

    def remesh(self, new_diloco_size: int) -> "ElasticDeviceMesh":
        """Close this mesh's rank pool and re-form it with another
        DiLoCo-axis size (a new store, a new rendezvous); the slots below
        the new size keep their nodes."""
        from repro_torch.core.rank_mesh import RankMesh
        if self.diloco_axis is None:
            raise ValueError("remesh needs a DiLoCo axis")
        old = self.mesh
        shape = tuple(new_diloco_size if a == self.diloco_axis else s
                      for a, s in old.shape.items())
        old.close()
        mesh = RankMesh(shape, old.axis_names, old.device,
                        local_backend=old.local_backend,
                        timeout=old.timeout)
        out = ElasticDeviceMesh(mesh, self.diloco_axis)
        for nid, slot in sorted(self.slots.slot_of.items(),
                                key=lambda kv: kv[1]):
            if slot < new_diloco_size:
                out.slots.slot_of[nid] = slot
        return out
