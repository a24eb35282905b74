"""ElasticTrainer: the PRIME training loop, stacked single-process
simulation (port of ``repro.train.loop``), synchronous and fault-free
configuration.

Per outer step t (paper Alg. 1 + §2.4):
  1. ``ClusterSimulator.begin_outer_step`` reports the live workers;
  2. every live slot runs H inner AdamW steps on its data shard;
  3. the int8 ring all-reduce averages the pseudo-gradients over the
     live workers, through ``RetryPolicy.run_collective``;
  4. the shared Nesterov outer step updates the anchor and every slot
     resets to it.

The k slots are stacked ``(k, ...)`` tensors on the model's device. The
inner step loops over the live slots with ``torch.autograd`` where the
JAX package ``vmap``s every slot and masks the inactive ones with
``jnp.where``; skipping them is the same result: their parameters and
AdamW state (``step`` included) stay untouched. Parameters and moments
are updated in place.

Not ported yet (raise ``NotImplementedError``): ``overlap="delayed"``
and chunked inner phases, membership events, contribution validation,
bandwidth-aware reordering, checkpoints and stream join.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import diloco as dl
from repro_torch.core.elastic_mesh import SlotAssignment
from repro_torch.core.fault_tolerance import ClusterSimulator, RetryPolicy
from repro_torch.core.sync_engine import leaves, tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.optim.adamw import AdamW, AdamWState


@dataclasses.dataclass
class TrainerConfig:
    diloco: dl.DiLoCoConfig
    inner_lr: float | Callable = 7.5e-5
    ckpt_dir: str | None = None
    max_workers: int = 16
    inner_chunks: int = 1
    validation: Any = None

    def __post_init__(self):
        if self.ckpt_dir is not None:
            raise NotImplementedError("checkpoints are not ported yet")
        if self.inner_chunks != 1:
            raise NotImplementedError(
                "chunked inner phases come with the overlapped sync, "
                "which is not ported yet")
        if self.validation is not None:
            raise NotImplementedError(
                "contribution validation is not ported yet")


def _stack(tree, k: int):
    return tree_map(lambda x: x[None].repeat((k,) + (1,) * x.dim()), tree)


def _slot(tree, s: int):
    return tree_map(lambda x: x[s], tree)


class ElasticTrainer:
    def __init__(self, model, cfg: TrainerConfig, data_cfg: DataConfig,
                 init_params, sim: ClusterSimulator, *,
                 batch_provider: Callable | None = None):
        if sim.events:
            raise NotImplementedError(
                "membership events are not ported yet: the port trains "
                "a fault-free cluster")
        self.model = model
        self.device = torch.device(model.device)
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.sim = sim
        # batch_provider(global_step, h, k) -> (H, k, ...) batch dict
        self.batch_provider = batch_provider
        self.optimizer = AdamW(lr=cfg.inner_lr)
        self.retry = RetryPolicy()
        self.slots = SlotAssignment(cfg.max_workers)
        for nid in sim.hb.live_ids():
            self.slots.assign(nid)
        k = self.k = cfg.max_workers
        init_params = tree_map(lambda x: x.to(self.device), init_params)
        self.params = _stack(init_params, k)
        zeros = lambda: tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), self.params)
        self.opt_state = AdamWState(
            torch.zeros((k,), dtype=torch.int32, device=self.device),
            zeros(), zeros())         # per-slot AdamW.init
        self.outer = dl.init_outer_state_sim(init_params, cfg.diloco, k)
        self.ring_order = tuple(range(k))
        self.history: list[dict] = []
        self._pipelines: dict[int, TokenPipeline] = {}

    # -- inner phase ----------------------------------------------------------

    def _inner_step(self, params, opt_state, batch, active) -> torch.Tensor:
        """One inner step of every live slot, in place. Returns the (k,)
        losses (NaN for inactive slots, which are not computed)."""
        losses = torch.full((self.k,), float("nan"), device=self.device)
        for s in np.flatnonzero(np.asarray(active) > 0).tolist():
            p = tree_map(lambda x: x[s].detach().requires_grad_(True), params)
            b = {key: v[s] for key, v in batch.items()}
            loss, metrics = self.model.loss(p, b)
            loss.backward()
            grads = tree_map(lambda x: x.grad, p)
            self.optimizer.update_(
                grads, AdamWState(opt_state.step[s], _slot(opt_state.m, s),
                                  _slot(opt_state.v, s)), _slot(params, s))
            losses[s] = metrics["loss"].detach()
            del p, grads, loss, metrics
        return losses

    def _inner_phase(self, params, opt_state, batches, active):
        """All H inner steps over pre-stacked (H, k, ...) batches ->
        (H, k) losses on the device."""
        h = batches["tokens"].shape[0]
        return torch.stack([
            self._inner_step(params, opt_state,
                             {key: v[i] for key, v in batches.items()},
                             active) for i in range(h)])

    def _run_inner_phase(self, batches, active):
        return self._inner_phase(self.params, self.opt_state, batches,
                                 active)

    def _pipeline(self, slot: int) -> TokenPipeline:
        if slot not in self._pipelines:
            self._pipelines[slot] = TokenPipeline(self.data_cfg, slot, self.k)
        return self._pipelines[slot]

    def _batches(self, step: int) -> dict:
        bs = [self._pipeline(s).batch_at(step) for s in range(self.k)]
        return {key: torch.stack([b[key] for b in bs]) for key in bs[0]}

    # -- outer loop -----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, n_outer_steps: int, *, inner_steps: int | None = None,
            bandwidth_sampler=None) -> list[dict]:
        if bandwidth_sampler is not None:
            raise NotImplementedError(
                "bandwidth-aware ring reordering is not ported yet")
        h = inner_steps or self.cfg.diloco.inner_steps
        global_step = int(self.outer.outer_step) * h
        for t in range(n_outer_steps):
            plan = self.sim.begin_outer_step(t)
            for nid in plan["live"]:
                self.slots.assign(nid)
            active = self.slots.live_mask(plan["live"])

            if self.batch_provider is not None:
                batches = self.batch_provider(global_step, h, self.k)
            else:
                per_step = [self._batches(global_step + i) for i in range(h)]
                batches = {key: torch.stack([b[key] for b in per_step])
                           for key in per_step[0]}
            batches = {key: torch.as_tensor(v).to(self.device)
                       for key, v in batches.items()}
            t0 = time.perf_counter()
            losses = self._run_inner_phase(batches, active)
            self._sync()
            t1 = time.perf_counter()
            global_step += h

            weights = self.slots.live_mask(
                plan["live"],
                zero_weight_ids=plan["joined"] + plan["stragglers"])

            def attempt(live_set):
                w = np.array(weights)
                for nid, slot in self.slots.slot_of.items():
                    if nid not in live_set:
                        w[slot] = 0.0
                return self._outer_sync(torch.as_tensor(w,
                                                        device=self.device))

            (new_params, self.outer), _, attempts = \
                self.retry.run_collective(attempt, plan["live"])
            with torch.no_grad():
                for dst, src in zip(leaves(self.params), leaves(new_params)):
                    dst.copy_(src)
            del new_params
            self._sync()
            t2 = time.perf_counter()

            live_w = np.asarray(weights) > 0
            mask = torch.as_tensor(live_w, device=self.device)
            mean_loss = (float(losses[-1][mask].mean()) if live_w.any()
                         else float("nan"))
            rec = {"outer_step": t, "live": plan["live"],
                   "joined": plan["joined"], "left": plan["left"],
                   "loss": mean_loss, "ring_order": self.ring_order,
                   "attempts": attempts,
                   "wire_bytes": dl.sync_wire_bytes(
                       _slot(self.params, 0), max(1, int(live_w.sum())),
                       self.cfg.diloco),
                   "inner_s": t1 - t0, "sync_s": t2 - t1}
            self.history.append(rec)
        return self.history

    def _outer_sync(self, weights):
        return dl.outer_sync_sim(self.params, self.outer, self.cfg.diloco,
                                 ring_order=self.ring_order[: self.k],
                                 weights=weights)
