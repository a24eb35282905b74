"""Double-buffered async snapshots (port of
``repro.checkpointing.snapshot``): move the device->host copy and the
persist off the trainer's critical path (paper §3.2: checkpoint saving
takes 60 s; the trainer overlaps it with the next inner phase).

``AsyncSnapshotter`` owns

  * N (default 2) **reusable host buffers**, one tensor per leaf,
    pinned when the leaf is on CUDA;
  * a single **writer thread** draining a FIFO of filled buffers, so
    persists never reorder and chained writers (the delta
    checkpointer's reference chain is stateful) stay correct;
  * **backpressure**: when every buffer is in flight, ``submit``
    blocks until the oldest persist finishes.

The port's trainer writes parameters and moments in place (AdamW, the
post-sync reset, joiners, poison), so a snapshot must hold the values of
the moment ``submit`` was called. ``submit`` issues every copy before it
returns: a CUDA leaf is copied with ``non_blocking=True`` on the current
stream and an event is recorded behind the copies, so any later write on
that stream runs after them; the writer thread waits on the event before
it reads the buffers. A write from another stream must first wait on the
current one. A CPU leaf is copied at once.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from repro_torch.checkpointing import checkpoint as _ckpt


class _Slot:
    __slots__ = ("tree", "busy", "bufs", "sig", "event")

    def __init__(self):
        self.tree = None
        self.busy = False
        self.bufs: dict[str, torch.Tensor] = {}
        self.sig = None
        self.event = None          # CUDA event behind the slot's copies


class AsyncSnapshotter:
    """``submit(step, tree, meta)`` snapshots to a host buffer and
    queues ``write_fn(step, host_tree, meta)`` on the writer thread."""

    def __init__(self, write_fn: Callable[[int, Any, dict], Any],
                 buffers: int = 2,
                 on_persist: Callable[[int, Any], None] | None = None):
        assert buffers >= 1
        self.write_fn = write_fn
        # called on the writer thread with (step, write_fn's return)
        # after each successful persist — the trainer uses it to track
        # which steps are actually on disk (what a ChunkPeer may
        # advertise / retention may count), not merely submitted
        self.on_persist = on_persist
        self._slots = [_Slot() for _ in range(buffers)]
        self._queue: list[tuple[_Slot, int, dict]] = []
        self._cv = threading.Condition()
        self._closed = False
        self._error: BaseException | None = None
        self._tasks_inflight = 0
        self.stats = {"submits": 0, "blocked_waits": 0, "writes": 0,
                      "tasks": 0}
        self._writer = threading.Thread(target=self._drain, daemon=True)
        self._writer.start()

    # -- writer thread -------------------------------------------------------

    def _drain(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                item = self._queue.pop(0)
                if item[0] == "task":
                    self._tasks_inflight += 1
            if item[0] == "task":
                _, fn = item
                try:
                    fn()
                except BaseException as e:
                    with self._cv:
                        self._error = e
                finally:
                    with self._cv:
                        self._tasks_inflight -= 1
                        self.stats["tasks"] += 1
                        self._cv.notify_all()
                continue
            _, slot, step, meta = item
            try:
                if slot.event is not None:
                    slot.event.synchronize()
                result = self.write_fn(step, slot.tree, meta)
                if self.on_persist is not None:
                    self.on_persist(step, result)
            except BaseException as e:  # surfaced on next submit/flush
                with self._cv:
                    self._error = e
            finally:
                with self._cv:
                    slot.busy = False
                    self.stats["writes"] += 1
                    self._cv.notify_all()

    # -- trainer side --------------------------------------------------------

    def _host_copy(self, slot: _Slot, tree: Any) -> None:
        """Device->host into the slot's reusable buffers (reallocated when
        the tree's structure, shapes or dtypes changed)."""
        flat = {k: _ckpt.as_tensor(v).detach()
                for k, v in _ckpt._flatten(tree).items()}
        sig = [(k, tuple(t.shape), t.dtype, t.is_cuda)
               for k, t in flat.items()]
        if sig != slot.sig:
            slot.bufs = {k: torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=t.is_cuda)
                         for k, t in flat.items()}
            slot.sig = sig
        on_cuda = False
        for k, t in flat.items():
            slot.bufs[k].copy_(t, non_blocking=t.is_cuda)
            on_cuda |= t.is_cuda
        slot.event = None
        if on_cuda:
            slot.event = torch.cuda.Event()
            slot.event.record()
        slot.tree = _ckpt.unflatten_like(tree, slot.bufs)

    def submit(self, step: int, tree: Any,
               extra_meta: dict | None = None) -> None:
        with self._cv:
            self._raise_pending()
            assert not self._closed, "snapshotter closed"
            slot = next((s for s in self._slots if not s.busy), None)
            if slot is None:
                self.stats["blocked_waits"] += 1
                while slot is None:
                    self._cv.wait()
                    slot = next((s for s in self._slots if not s.busy),
                                None)
            slot.busy = True
        try:
            self._host_copy(slot, tree)
        except BaseException:
            with self._cv:   # don't leak the slot: that deadlocks
                slot.busy = False
                self._cv.notify_all()
            raise
        with self._cv:
            self.stats["submits"] += 1
            self._queue.append(("write", slot, int(step),
                                extra_meta or {}))
            self._cv.notify_all()

    def submit_task(self, fn: Callable[[], Any]) -> None:
        """Queue an arbitrary maintenance callable (e.g. ChunkStore.gc)
        BEHIND all pending persists — FIFO with writes, so retention
        never deletes chunks of a checkpoint still being written."""
        with self._cv:
            self._raise_pending()
            assert not self._closed, "snapshotter closed"
            self._queue.append(("task", fn))
            self._cv.notify_all()

    def flush(self, timeout: float | None = None) -> None:
        """Block until every queued persist has finished. Raises
        ``TimeoutError`` if they haven't within ``timeout``."""
        with self._cv:
            done = self._cv.wait_for(
                lambda: not self._queue
                and not any(s.busy for s in self._slots)
                and self._tasks_inflight == 0,
                timeout=timeout)
            self._raise_pending()
            if not done:
                raise TimeoutError(
                    f"snapshot persists still pending after {timeout}s")

    def close(self, timeout: float | None = 30.0) -> None:
        self.flush(timeout=timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._writer.join(timeout=5)

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err
