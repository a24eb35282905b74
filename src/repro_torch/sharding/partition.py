"""Buffer layouts over a rank mesh (port of ``repro.sharding.partition``,
the distributed outer sync's part: ``wan_ring_specs``).

A spec is a tuple with one entry per leading dimension of a buffer: the
mesh axis, or the tuple of axes (row-major), that the dimension is laid
over, as a ``PartitionSpec``'s entries are. A rank's part of the buffer
is the index its coordinates give along those dimensions
(``core.rank_mesh.axes_index``).
"""
from __future__ import annotations


def wan_ring_specs(wan_axis: str,
                   local_axes: tuple[str, ...] = ()) -> tuple[tuple, tuple]:
    """Specs of the distributed outer-sync ring's buffers.

    Returns ``(row_spec, acc_spec)``: per-worker flat rows —
    pseudo-gradients, thetas, weights — lie over the WAN (DiLoCo) axis
    only (``(wan_axis,)``); the in-flight ring accumulators add a
    dimension over the intra-node axes (``(wan_axis, local_axes)``), one
    slice per local rank in hierarchical mode, one replica per local rank
    otherwise (the paper's ElasticDeviceMesh split, see
    ``core.elastic_mesh.hierarchy``)."""
    row = (wan_axis,)
    if not local_axes:
        return row, row
    # one axis stands alone, as a ``PartitionSpec`` entry normalizes
    local = local_axes[0] if len(local_axes) == 1 else tuple(local_axes)
    return row, (wan_axis, local)

