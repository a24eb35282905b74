"""DiLoCo's first outer steps, followed in plain PyTorch from the weights
and batches the benchmark hands over (INTELLECT-1 Alg. 1).

k workers start from the same parameters. In each outer step every
worker takes its inner AdamW steps on its own rows; then the anchor (the
fp32 parameters all workers started the step from) takes one Nesterov
step on the ring mean of the pseudo-gradients ``anchor - theta_i``
(``codec.ring_mean``, over the parameters flattened in sorted-key
order), and every worker restarts from the new anchor, rounded to the
stored dtype. AdamW's moments and step count carry over.

``follow`` returns what the benchmark compares with the program: the
loss of each outer step (the workers' mean on its last inner step), the
norm of each tensor's AdamW first moment after the first outer step
(the gradients as the optimizer holds them) for each worker, and the
norm of each tensor's change from the start after the last outer step,
for each worker.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from . import codec, model, optim


@dataclasses.dataclass(frozen=True)
class Job:
    workers: int
    adamw: optim.AdamWConfig
    outer_lr: float
    outer_momentum: float


def leaves(tree, prefix=()):
    """(name, tensor) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaves(tree[k], prefix + (k,)))
        return out
    return [("/".join(prefix), tree)]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _widen(tree):
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return tree.detach().float().requires_grad_(True)


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for _, t in leaves(tree)])


@torch.no_grad()
def _load(tree, flat: torch.Tensor) -> None:
    off = 0
    for _, t in leaves(tree):
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


class _Clock:
    """Wall seconds between laps, the device synchronised at each."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.t = time.perf_counter()

    def lap(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        t, self.t = self.t, time.perf_counter()
        return self.t - t


def follow(spec: model.ModelSpec, job: Job, params0, batches, *,
           prec: model.Precision = model.Precision(),
           fault: str | None = None) -> dict:
    """Follow ``len(batches)`` outer steps. ``batches[t]`` is an int
    tensor (h, k, B, S + 1) of token rows: inputs are a row's first S
    tokens and targets its last S. ``fault`` plants one of the faults
    the benchmark's check must catch: ``"half_batch"`` (each worker
    step trains on the first half of its rows), ``"same_batch"`` (every
    inner step of an outer step trains on that step's first rows) or
    ``"no_exchange"`` (the ring moves nothing between workers)."""
    k = job.workers
    names = [n for n, _ in leaves(params0)]
    params = [_clone(params0) for _ in range(k)]
    moments = [[(torch.zeros(t.shape, dtype=torch.float32, device=t.device),
                 torch.zeros(t.shape, dtype=torch.float32, device=t.device))
                for _, t in leaves(params0)] for _ in range(k)]
    steps = [0] * k
    anchor = _flat(params0)
    mom = torch.zeros_like(anchor)
    out = {"loss": [], "moment1": {n: [0.0] * k for n in names},
           "change": {}, "seconds": {"inner": 0.0, "sync": 0.0}}
    clock = _Clock(anchor.device)
    for t, rows in enumerate(batches):
        last = []
        for i in range(rows.shape[0]):
            for w in range(k):
                seq = rows[0 if fault == "same_batch" else i, w]
                if fault == "half_batch":
                    seq = seq[: seq.shape[0] // 2]
                p32 = _widen(params[w])
                flat32 = [x for _, x in leaves(p32)]
                loss = model.loss_fn(spec, p32, seq[:, :-1], seq[:, 1:],
                                     prec)
                grads = torch.autograd.grad(loss, flat32)
                del p32, flat32
                steps[w] += 1
                for j, ((n, p), g) in enumerate(zip(leaves(params[w]),
                                                    grads)):
                    optim.adamw_step(p, g, *moments[w][j], steps[w],
                                     job.adamw)
                del grads
                if i == rows.shape[0] - 1:
                    last.append(float(loss.detach()))
        out["loss"].append(sum(last) / k)
        if t == 0:
            for w in range(k):
                for n, (m, _) in zip(names, moments[w]):
                    out["moment1"][n][w] = float(
                        torch.linalg.vector_norm(m.double()))
        out["seconds"]["inner"] += clock.lap()
        pgs = torch.stack([anchor - _flat(params[w]) for w in range(k)])
        delta = codec.ring_mean(pgs, exchange=fault != "no_exchange")
        del pgs
        optim.nesterov_step(anchor, mom, delta, job.outer_lr,
                            job.outer_momentum)
        del delta
        for w in range(k):
            _load(params[w], anchor)
        out["seconds"]["sync"] += clock.lap()
    with torch.no_grad():
        for n, p0 in leaves(params0):
            out["change"][n] = [
                float(torch.linalg.vector_norm(
                    (dict(leaves(params[w]))[n].double() - p0.double())))
                for w in range(k)]
    return out
