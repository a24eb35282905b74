"""Per-rank cost of a traced step (the port's counterpart of
``repro.analysis.hlo_cost``: torch has no HLO to parse).

``OpCounter`` is a dispatch mode: run one rank's step under it (the dry
run does so on fake tensors in a fake world, ``launch.mesh.
make_production_mesh``) and it counts, op by op:

  * FLOPs, through ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions, attention; other ops count none, as there);
  * HBM bytes, as the bytes of every tensor an op reads plus every one
    it writes, for each op that is not a view. This is UNFUSED: each op
    is charged its own round trip to memory, where a fused or compiled
    step would keep intermediates on chip, so it is an upper bound;
  * wire bytes of each collective, with the reference's ring byte model
    (``repro.analysis.roofline``): an all-gather its result, a
    reduce-scatter its operand, an all-reduce twice its operand, an
    all-to-all and a point-to-point send their operand (a receive
    counts nothing: its bytes are the sender's).

The step's Python loops run as Python: a loop over 24 layers dispatches
24 layers' ops, so every op is counted once per iteration by
construction, which is what ``hlo_cost``'s while-loop trip counts exist
for. Collectives count no HBM bytes and no FLOPs.
"""
from __future__ import annotations

import collections
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# collective op -> (kind, what its wire bytes are): "result" the output,
# "operand" the input, "operand2" twice the input, "none" nothing.
# Functional collectives (DTensor's) return their result; c10d's eager
# ops take lists and write in place, (outputs, inputs, ...) or (tensors,)
_FUNCTIONAL = {
    "all_gather_into_tensor": ("all-gather", "result"),
    "all_gather_into_tensor_coalesced": ("all-gather", "result"),
    "reduce_scatter_tensor": ("reduce-scatter", "operand"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "operand"),
    "all_reduce": ("all-reduce", "operand2"),
    "all_reduce_": ("all-reduce", "operand2"),
    "all_reduce_coalesced": ("all-reduce", "operand2"),
    "all_to_all_single": ("all-to-all", "operand"),
    "broadcast": ("broadcast", "operand"),
}
_C10D = {
    "allgather_": ("all-gather", "result"),
    "_allgather_base_": ("all-gather", "result"),
    "allgather_into_tensor_coalesced_": ("all-gather", "result"),
    "reduce_scatter_": ("reduce-scatter", "operand"),
    "_reduce_scatter_base_": ("reduce-scatter", "operand"),
    "allreduce_": ("all-reduce", "operand2"),
    "allreduce_coalesced_": ("all-reduce", "operand2"),
    "alltoall_": ("all-to-all", "operand"),
    "alltoall_base_": ("all-to-all", "operand"),
    "broadcast_": ("broadcast", "operand"),
    "send": ("p2p", "operand"),
    "recv_": ("p2p", "none"),
    "recv_any_source_": ("p2p", "none"),
}
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "broadcast", "p2p")
# ops that move no data (metadata, allocation, a reshape's result view)
_FREE = {"detach", "alias", "lift_fresh", "_local_scalar_dense", "empty",
         "empty_strided", "empty_like", "set_", "resize_", "_unsafe_view",
         "wait_tensor"}


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _is_view(func) -> bool:
    """An op whose result aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


@dataclasses.dataclass
class OpCost:
    """One rank's counts of a traced step."""

    flops: float = 0.0
    hbm_bytes: float = 0.0                 # unfused upper bound
    wire_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0.0))
    collective_calls: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))
    ops: int = 0
    flops_by_op: dict = dataclasses.field(
        default_factory=collections.Counter)


class OpCounter(TorchDispatchMode):
    """Counts a step's FLOPs, HBM bytes and collective wire bytes into
    ``self.cost`` (an ``OpCost``) while it is entered."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.cost = OpCost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _charge(self, kind: str, nbytes: int) -> None:
        c = self.cost
        c.collective_bytes[kind] += nbytes
        c.collective_calls[kind] += 1
        c.wire_bytes += nbytes

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind, which = _FUNCTIONAL[name]
            src = out if which == "result" else args[0]
        elif ns == "c10d" and name in _C10D:
            kind, which = _C10D[name]
            # (outputs, inputs, ...): an operand is the inputs' list
            two = name.startswith(("alltoall", "reduce_scatter",
                                   "_reduce_scatter", "_allgather"))
            src = args[1] if two and which != "result" else args[0]
        else:
            kind = None
        if kind is not None:
            n = 0 if which == "none" else _nbytes(_tensors(src))
            self._charge(kind, 2 * n if which == "operand2" else n)
            return
        if ns in ("_c10d_functional", "c10d", "prim") or name in _FREE:
            return
        c = self.cost
        c.ops += 1
        packet = func._overloadpacket
        if packet in self._flops:
            n = self._flops[packet](*args, **kwargs, out_val=out)
            c.flops += n
            c.flops_by_op[str(packet)] += n
        if _is_view(func):
            return
        c.hbm_bytes += _nbytes(_tensors(args) + _tensors(kwargs)
                               + _tensors(out))
