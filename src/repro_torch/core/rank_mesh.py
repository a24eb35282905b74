"""A mesh of rank processes under one controller: the torch counterpart
of a ``jax.sharding.Mesh`` for the distributed outer sync.

The JAX package runs one controller over a mesh of devices and moves
data between them with collectives inside ``shard_map`` programs. Here
each mesh position is a process (``torch.multiprocessing``, ``spawn``)
and the controller is the caller's process, which joins no process
group. The ranks form one ``torch.distributed`` world (gloo, rendezvous
through a ``FileStore`` in a fresh temporary directory, so no port is
fixed); groups along mesh axes are made on demand (``group``), each
with an explicit backend and the mesh's finite timeout.

The controller drives the ranks over a command channel (one pipe per
rank): ``submit`` sends a command to every rank and returns without
waiting, ``call`` sends one and waits for every rank's result. A
command is an importable function run as ``fn(ctx, *args)`` in each
rank (``RankContext``); tensors in the arguments travel by
``torch.multiprocessing``'s sharing (shared memory on the CPU, CUDA IPC
handles on the card), so the ranks read and write the controller's
buffers in place and the controller keeps them alive meanwhile.

Ranks are numbered row-major over the mesh's axes. A rank that raises
reports its traceback and exits; a rank that dies, or one whose oldest
pending command makes no progress within the timeout, makes the
controller raise ``RankFailure`` and the mesh unusable. ``close()``
stops every rank and leaves no child process.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import shutil
import tempfile
import time
import traceback
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

_POLL_S = 0.05
# how long a failure waits for ranks that are dying to be reaped, so its
# message names every rank that exited (a killed rank's sockets close
# before its exit code can be read)
_REAP_S = 1.0


class RankFailure(RuntimeError):
    """A rank died, raised, or made no progress within the timeout."""


@dataclasses.dataclass
class RankContext:
    """What a command function sees inside a rank process."""

    rank: int
    shape: dict[str, int]          # axis name -> size, in mesh order
    coords: dict[str, int]         # this rank's index along each axis
    device: torch.device
    timeout: datetime.timedelta
    # (axes, backend) -> (ProcessGroup, member global ranks in fiber
    # order); made by ``RankMesh.group``
    groups: dict = dataclasses.field(default_factory=dict)
    # per-rank state that command functions keep between commands
    state: dict = dataclasses.field(default_factory=dict)

    def sync(self) -> None:
        """Wait for this rank's device work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def axes_index(shape: dict[str, int], axes: Sequence[str],
               coords: dict[str, int]) -> int:
    """Row-major index of ``coords`` over ``axes``, in mesh order (a
    missing coordinate counts as 0): over every axis, the global rank;
    over the non-DiLoCo axes, the local rank and a rank's place in its
    local group."""
    idx = 0
    for a in shape:
        if a in axes:
            idx = idx * shape[a] + coords.get(a, 0)
    return idx


def fiber_ranks(shape: dict[str, int], axes: Sequence[str],
                coords: dict[str, int]) -> list[int]:
    """Global ranks of the fiber through ``coords`` along ``axes``:
    every rank that differs from ``coords`` only in ``axes``, row-major
    over ``axes`` in mesh order (the order an all-gather concatenates)."""
    along = [a for a in shape if a in axes]
    out = []
    for idx in itertools.product(*(range(shape[a]) for a in along)):
        c = dict(coords)
        c.update(zip(along, idx))
        out.append(axes_index(shape, list(shape), c))
    return out


def _make_groups(ctx: RankContext, axes: tuple, backend: str) -> None:
    """Collective: every rank makes every fiber's group along ``axes``
    (``new_group`` must be called by the whole world, in one order) and
    keeps its own."""
    import torch.distributed as dist
    names = list(ctx.shape)
    rest = [a for a in names if a not in axes]
    for idx in itertools.product(*(range(ctx.shape[a]) for a in rest)):
        base = dict(zip(rest, idx))
        base.update({a: 0 for a in axes})
        ranks = fiber_ranks(ctx.shape, axes, base)
        group = dist.new_group(ranks, timeout=ctx.timeout, backend=backend)
        if ctx.rank in ranks:
            ctx.groups[(axes, backend)] = (group, ranks)


def _rank_main(rank: int, shape: dict, device: str, store_path: str,
               timeout_s: float, conn) -> None:
    """A rank process: join the world, then run commands until the
    controller sends ``None`` or goes away."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    # the ranks talk over loopback: one host, no network needed
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    seq = 0
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        world = math.prod(shape.values())
        timeout = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timeout)
        coords = dict(zip(shape, (int(i) for i in np.unravel_index(
            rank, tuple(shape.values())))))
        ctx = RankContext(rank, dict(shape), coords, dev, timeout)
        conn.send(("done", 0, None))
        while True:
            msg = conn.recv()
            if msg is None:
                break
            seq, fn, args, reply = msg
            result = fn(ctx, *args)
            conn.send(("ok" if reply else "done", seq,
                       result if reply else None))
        # release the controller's shared buffers before leaving
        ctx.state.clear()
        ctx.sync()
        dist.destroy_process_group()
    except EOFError:
        pass                              # the controller went away
    except BaseException:
        try:
            conn.send(("error", seq, traceback.format_exc()))
        finally:
            # peers may still block on this rank: leave at once
            os._exit(1)


def _shutdown(procs, conns, tmpdir) -> None:
    """Stop every rank (politely, then by force) and remove the store."""
    for conn, proc in zip(conns, procs):
        if proc.is_alive():
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
    deadline = time.monotonic() + 10.0
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(5.0)
    for conn in conns:
        conn.close()
    shutil.rmtree(tmpdir, ignore_errors=True)


class RankMesh:
    """``shape`` ranks over ``axis_names``, each a process on ``device``
    (default ``"cuda"``; several ranks share one card). ``local_backend``
    is the backend of groups over the non-DiLoCo axes (``"gloo"`` or
    ``"nccl"``); it is taken as given, never picked from the device, and
    NCCL needs one card per rank of a group. ``timeout`` (seconds) bounds
    every group's operations and how long a command may go without
    progress."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None, *, local_backend: str = "gloo",
                 timeout: float = 60.0):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} vs axes {axis_names}")
        if local_backend not in ("gloo", "nccl"):
            raise ValueError(f"local_backend {local_backend!r}: want "
                             "'gloo' or 'nccl'")
        self.shape = dict(zip(axis_names, (int(s) for s in shape)))
        self.axis_names = tuple(axis_names)
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        self.device = dev
        self.local_backend = local_backend
        self.timeout = float(timeout)
        self.size = math.prod(self.shape.values())
        self.failed: RankFailure | None = None
        self._groups: set = set()
        self._seq = 0
        self._ids = itertools.count(1)
        self._tmpdir = tempfile.mkdtemp(prefix="rank_mesh_")
        mp = torch.multiprocessing.get_context("spawn")
        self._procs, self._conns = [], []
        self._finalizer = weakref.finalize(
            self, _shutdown, self._procs, self._conns, self._tmpdir)
        store = os.path.join(self._tmpdir, "store")
        for rank in range(self.size):
            parent, child = mp.Pipe()
            proc = mp.Process(
                target=_rank_main, daemon=True,
                args=(rank, self.shape, str(self.device), store,
                      self.timeout, child),
                name=f"rank_mesh-{rank}")
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        # per rank: seq of the last command completed, commands pending,
        # and when its oldest pending command became the head
        self._done = [-1] * self.size
        self._pending = [1] * self.size        # the rendezvous
        self._since = [time.monotonic()] * self.size
        self._results: dict = {}
        self._wait(0)

    # -- commands -------------------------------------------------------------

    def new_id(self) -> int:
        """A fresh id for state the ranks keep between commands."""
        return next(self._ids)

    def coords(self, rank: int) -> dict[str, int]:
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return dict(zip(self.shape, (int(i) for i in idx)))

    def submit(self, fn: Callable, *args, reply: bool = False) -> int:
        """Send ``fn(ctx, *args)`` to every rank; return at once with the
        command's sequence number."""
        self.poll()
        self._seq += 1
        now = time.monotonic()
        for r, conn in enumerate(self._conns):
            if self._pending[r] == 0:
                self._since[r] = now
            self._pending[r] += 1
            conn.send((self._seq, fn, args, reply))
        return self._seq

    def call(self, fn: Callable, *args) -> list:
        """Run ``fn(ctx, *args)`` on every rank and return the results,
        by rank."""
        seq = self.submit(fn, *args, reply=True)
        self._wait(seq)
        return [self._results.pop((r, seq)) for r in range(self.size)]

    def group(self, axes: Sequence[str], backend: str = "gloo") -> tuple:
        """The key of the groups along ``axes`` (made once, collectively):
        a rank finds its group as ``ctx.groups[key]``."""
        key = (tuple(a for a in self.axis_names if a in axes), backend)
        if key not in self._groups:
            self.call(_make_groups, *key)
            self._groups.add(key)
        return key

    def poll(self) -> None:
        """Take every message the ranks have sent, without waiting;
        raise ``RankFailure`` if a rank failed, died or stalled."""
        self._check()
        now = time.monotonic()
        errors, closed = [], []
        for r, (conn, proc) in enumerate(zip(self._conns, self._procs)):
            # read before draining: what a rank sent before it died is
            # then drained below
            dead = proc.exitcode is not None
            raised = False
            while conn.poll():
                try:
                    kind, seq, payload = conn.recv()
                except (EOFError, OSError):
                    closed.append(r)
                    break
                if kind == "error":
                    errors.append(f"rank {r} raised:\n{payload}")
                    raised = True
                    continue
                self._done[r] = seq
                self._pending[r] -= 1
                self._since[r] = now
                if kind == "ok":
                    self._results[(r, seq)] = payload
            if dead and not raised:
                errors.append(f"rank {r} exited with code {proc.exitcode}")
            elif self._pending[r] and now - self._since[r] > self.timeout:
                errors.append(f"rank {r}: no progress in "
                              f"{self.timeout:.0f} s")
        if errors:
            self._fail("\n".join(errors + self._reap(closed, errors)))

    def _reap(self, closed: list[int], errors: list[str]) -> list[str]:
        """On a failure, wait up to ``_REAP_S`` for the ranks in
        ``closed``, whose pipe reached its end: they are dying, and a rank
        whose peer was killed can report the closed connection before the
        killed rank's exit code is readable. A live rank is not waited
        for. Returns a line for each rank that exited and ``errors`` does
        not name yet."""
        deadline = time.monotonic() + _REAP_S
        lines = []
        for r in closed:
            proc = self._procs[r]
            if proc.exitcode is None:
                proc.join(max(0.0, deadline - time.monotonic()))
            if proc.exitcode is not None and \
                    not any(e.startswith(f"rank {r} exited") for e in errors):
                lines.append(f"rank {r} exited with code {proc.exitcode}")
        return lines

    def _wait(self, seq: int) -> None:
        """Block until every rank has completed command ``seq``."""
        while True:
            self.poll()
            late = [r for r in range(self.size) if self._done[r] < seq]
            if not late:
                return
            self._conns[late[0]].poll(_POLL_S)

    def _check(self) -> None:
        if self.failed is not None:
            raise RankFailure(f"the rank mesh failed earlier: {self.failed}")

    def _fail(self, msg: str) -> None:
        self.failed = RankFailure(msg)
        self.close()
        raise self.failed

    # -- lifetime -------------------------------------------------------------

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    def alive(self) -> list[bool]:
        return [p.is_alive() for p in self._procs]

    def close(self) -> None:
        """Stop every rank process and remove the store. Idempotent."""
        self._finalizer()
        if self.failed is None:
            self.failed = RankFailure("the rank mesh is closed")

    def __enter__(self) -> "RankMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
