"""Elastic slot bookkeeping (port of ``repro.core.elastic_mesh``,
``SlotAssignment`` only): stable node ids map to DiLoCo slots with
free-list reuse, and per-slot ring weights are 1 for contributing
workers and 0 for joiners, stragglers and empty slots (mask and
renormalize, as the paper's "join with zero pseudo-gradient").
``ElasticDeviceMesh`` and the hierarchy spec come with the distributed
slice."""
from __future__ import annotations

import dataclasses

import numpy as np


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
