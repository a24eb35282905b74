"""Serving engines over the model's prefill / decode steps (port of
``repro.serving.engine``).

Two schedulers share one protocol (submit / step / run_until_drained):

* ``WaveEngine`` — the static batcher, kept as the A/B foil: admission
  only at wave boundaries and one host round-trip per slot per decoded
  token (``int(next_tok[slot])``). Greedy only.

* ``ContinuousEngine`` — slot-level continuous batching with the decode
  loop kept on the device:
    - the B-slot cache is allocated once; per-slot cache lengths let a
      new request prefill while the other slots keep decoding;
    - admission prefills the waiting requests as one batch (rows padded
      to a power of two, prompts right-padded to a power-of-two bucket,
      exact per-slot semantics via ``prompt_len``) and copies each row's
      cache into its slot;
    - a decode chunk runs N decode+sample steps without a host read:
      sampling (greedy, temperature, top-k, top-p), the per-slot
      ``done`` and ``remaining`` flags and the (N, B) token block stay
      on the device, and one transfer per chunk brings the block (and
      the first tokens of the requests admitted before it) to the host;
    - with ``overlap_admission`` the queued requests prefill (batch 1)
      after a chunk is enqueued and before its token block is read
      back, and splice into slots at the next chunk boundary.

``serving.paging.PagedEngine`` is a ``ContinuousEngine`` over a paged
KV pool; it plugs into the scheduler seams ``_make_cache``,
``_release_slot``, ``_before_chunk`` and ``_after_chunk``.

Both engines give identical greedy tokens. Sampled tokens come from one
``torch.Generator`` per request, seeded from (engine seed, rid), so they
do not depend on the slot a request lands in or on its neighbours; they
cannot match the JAX package's key streams.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models import attention as attn

MIN_BUCKET = 8        # smallest prompt pad bucket
NEG_INF = -1e30


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 = greedy (wave engine is greedy-only)
    out_tokens: list = dataclasses.field(default_factory=list)
    # log-prob of each emitted token under the SAMPLING distribution
    # (logits / temperature, before top-k / top-p; temperature 0 scores
    # the unscaled softmax), 1:1 with out_tokens; filled only by an
    # engine with capture_logprobs=True (the RL rollout path)
    out_logprobs: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float | None = None
    t_first: float | None = None  # first token available
    t_done: float | None = None


def bucket_len(n: int) -> int:
    """Next power of two >= n (floor MIN_BUCKET)."""
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


def bucket_batch(n: int) -> int:
    """Next power of two >= n (floor 1): admission prefill batch sizes."""
    b = 1
    while b < n:
        b *= 2
    return b


def nucleus_mask(scaled: torch.Tensor, top_p: float) -> torch.Tensor:
    """(B, V) temperature-scaled logits -> bool keep-mask of the smallest
    token set whose probability mass reaches ``top_p`` (sorted cumsum;
    the top-1 token always survives; ties at the threshold are kept)."""
    srt = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    thresh = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
    return scaled >= thresh


def gumbel(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """n standard Gumbel draws from ``generator``."""
    e = torch.empty(n, dtype=torch.float32, device=device)
    return e.exponential_(generator=generator).log_().neg_()


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  noise: torch.Tensor | None = None, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """Per-slot sampling on the device. logits (B, V), temps (B,).

    temp == 0 -> greedy argmax; temp > 0 -> a categorical draw over
    logits/temp by the Gumbel-max trick with ``noise`` (B, V) standard
    Gumbel draws, optionally nucleus- (first, on the scaled
    distribution) and top-k-masked. ``noise=None`` means every slot is
    greedy."""
    lg = logits.float()
    greedy = lg.argmax(dim=-1)
    if noise is None:
        return greedy.to(torch.int32)
    safe = torch.where(temps > 0, temps, 1.0)[:, None]
    if top_p and top_p > 0.0:
        lg = torch.where(nucleus_mask(lg / safe, top_p), lg, NEG_INF)
    if top_k and top_k > 0:
        vals, idx = lg.topk(top_k, dim=-1)
        choice = (vals / safe + noise[:, :top_k]).argmax(dim=-1)
        sampled = idx.gather(-1, choice[:, None])[:, 0]
    else:
        sampled = (lg / safe + noise).argmax(dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def chosen_logprob(logits: torch.Tensor, toks: torch.Tensor,
                   temps: torch.Tensor) -> torch.Tensor:
    """Log-prob (B,) fp32 of ``toks`` (B,) under softmax(logits / temp)
    per slot: the behaviour-policy score an RL trainer needs beside each
    sampled token. A temperature-0 slot scores the unscaled
    distribution."""
    safe = torch.where(temps > 0, temps, 1.0)[:, None]
    logp = torch.log_softmax(logits.float() / safe, dim=-1)
    return logp.gather(-1, toks.long()[:, None])[:, 0]


def copy_state_rows(cache: dict, sub: dict, slot: int, row: int) -> None:
    """Row ``row`` of every state leaf of ``sub`` (an SSM's states and
    conv rings, slot axis 1) into ``slot`` of ``cache``'s, in place."""
    for big, small in zip(attn.state_leaves(cache), attn.state_leaves(sub),
                          strict=True):
        big[:, slot] = small[:, row]


def request_generator(seed: int, rid: int, device) -> torch.Generator:
    """The sampling stream of request ``rid`` under engine ``seed``."""
    mixed = np.random.SeedSequence([seed, rid]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]))


class _EngineBase:
    kind = ""

    def __init__(self, model, params, *, batch_slots: int = 4,
                 max_len: int = 512, eos_id: int = 1, pad_id: int = 0,
                 bucket_prompts: bool = True):
        if model.cfg.family == "encdec":
            # the engines prefill token prompts; an enc-dec prefill takes
            # a source and a BOS token (the JAX package's engines fail
            # on it with a KeyError)
            raise ValueError(f"{type(self).__name__}: serving unsupported "
                             "for family 'encdec' (its prefill takes "
                             "src_embeds and bos, not prompt tokens)")
        self.model = model
        self.params = params
        self.device = model.device
        self.slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.bucket_prompts = bucket_prompts
        self.cfg = model.cfg
        self.shape = ShapeConfig("serve", "decode", max_len, batch_slots)
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * batch_slots
        self.latencies: list[float] = []
        self.wall: float = 0.0
        self.stats = {"decode_steps": 0, "tokens_out": 0,
                      "host_syncs": 0, "admitted": 0,
                      "busy_slot_steps": 0, "total_slot_steps": 0,
                      "prefill_widths": set()}

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def reset_metrics(self) -> None:
        """Zero counters and latencies (keeps device state)."""
        for k, v in self.stats.items():
            self.stats[k] = set() if isinstance(v, set) else 0
        self.latencies = []
        self.wall = 0.0

    # -- admission helpers ----------------------------------------------------

    def _padded_len(self, n: int) -> int:
        """Pad width for an n-token prompt: a power-of-two bucket."""
        if not self.bucket_prompts:
            return n
        return max(min(bucket_len(n), self.max_len), n)

    def _budget(self, req: Request) -> int:
        """Total tokens this request may emit (cache-capacity-clamped
        for non-rolling attention caches; SSM state is O(1) and SWA
        rings wrap, so no cap there)."""
        cfg = self.cfg
        capless = (cfg.sliding_window is not None
                   or (cfg.family in ("ssm", "hybrid")
                       and not cfg.attn_every))
        if capless:
            return max(1, req.max_new_tokens)
        return max(1, min(req.max_new_tokens,
                          self.max_len - len(req.prompt)))

    def _check_prompt(self, req: Request) -> None:
        if not 1 <= len(req.prompt) <= self.max_len:
            raise ValueError(f"prompt length {len(req.prompt)} vs "
                             f"max_len {self.max_len}")

    def _prefill(self, tokens: np.ndarray, plen: np.ndarray):
        """Prefill right-padded prompts into a FRESH cache: the port's
        cache writes are in place, so a reused template would carry one
        admission's K/V and lengths into the next."""
        self.stats["prefill_widths"].add(tokens.shape[1])
        cache = self.model.init_cache(tokens.shape[0], self.shape)
        return self.model.prefill(
            self.params,
            {"tokens": torch.from_numpy(tokens).to(self.device),
             "prompt_len": torch.from_numpy(plen).to(self.device)},
            cache)

    def _retire(self, req: Request) -> None:
        req.done = True
        req.t_done = time.perf_counter()
        self.latencies.append(req.t_done - req.t_submit)

    # -- protocol -------------------------------------------------------------

    def step(self) -> int:
        raise NotImplementedError

    def _waiting(self) -> bool:
        """Requests submitted but not yet in a slot."""
        return bool(self.queue)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        t0 = time.perf_counter()
        for _ in range(max_steps):
            if self.step() == 0 and not self._waiting():
                break
        self.wall += time.perf_counter() - t0

    def perf_summary(self) -> dict:
        lat = sorted(self.latencies)
        pct = (lambda p: lat[min(len(lat) - 1,
                                 int(p / 100 * len(lat)))]) if lat \
            else (lambda p: float("nan"))
        occ = (self.stats["busy_slot_steps"]
               / max(1, self.stats["total_slot_steps"]))
        return {
            "engine": self.kind,
            "requests": len(lat),
            "tokens_out": self.stats["tokens_out"],
            "decode_steps": self.stats["decode_steps"],
            "wall_s": self.wall,
            "tokens_per_s": self.stats["tokens_out"] / self.wall
            if self.wall else float("nan"),
            "latency_p50_s": pct(50),
            "latency_p95_s": pct(95),
            "slot_occupancy": occ,
            "host_syncs": self.stats["host_syncs"],
            "prefill_widths": sorted(self.stats["prefill_widths"]),
        }


# -- wave (static) batching ---------------------------------------------------


class WaveEngine(_EngineBase):
    """Wave-scheduled static batching: all-free admission, lockstep
    decode, one host sync per slot per token. Greedy only."""
    kind = "wave"

    def __init__(self, model, params, **kw):
        super().__init__(model, params, **kw)
        self.cache = None
        self.tokens = None
        self.remaining = np.zeros((self.slots,), np.int64)
        self.stats["waves"] = 0

    def submit(self, req: Request) -> None:
        if req.temperature > 0:
            raise ValueError(
                "WaveEngine is greedy-only (it exists as the A/B "
                "foil); use ContinuousEngine for sampled requests")
        super().submit(req)

    def _admit_wave(self) -> bool:
        if not self.queue:
            return False
        wave: list[Request] = []
        while self.queue and len(wave) < self.slots:
            wave.append(self.queue.popleft())
        for w in wave:
            self._check_prompt(w)
        padded = self._padded_len(max(len(w.prompt) for w in wave))
        tokens = np.full((self.slots, padded), self.pad_id, np.int32)
        plen = np.ones((self.slots,), np.int32)
        for i, w in enumerate(wave):
            tokens[i, :len(w.prompt)] = w.prompt        # RIGHT-pad
            plen[i] = len(w.prompt)
        logits, self.cache = self._prefill(tokens, plen)
        first = logits.argmax(dim=-1).to(torch.int32)
        self.tokens = first[:, None]
        now = time.perf_counter()
        for i in range(self.slots):
            req = wave[i] if i < len(wave) else None
            self.active[i] = req
            self.remaining[i] = 0
            if req is None:
                continue
            tok = int(first[i])
            req.out_tokens.append(tok)
            req.t_first = now
            self.stats["tokens_out"] += 1
            budget = self._budget(req)
            self.remaining[i] = budget - 1
            if tok == self.eos_id or budget <= 1:
                self._retire(req)
                self.active[i] = None
        self.stats["waves"] += 1
        self.stats["admitted"] += len(wave)
        return True

    def step(self) -> int:
        """One engine iteration; returns the number of active slots."""
        if not any(r is not None for r in self.active):
            if not self._admit_wave():
                return 0
        logits, self.cache = self.model.decode(self.params, self.tokens,
                                               self.cache)
        next_tok = logits.argmax(dim=-1).to(torch.int32)
        self.stats["decode_steps"] += 1
        self.stats["total_slot_steps"] += self.slots
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(next_tok[slot])           # host sync PER TOKEN
            self.stats["host_syncs"] += 1
            self.stats["busy_slot_steps"] += 1
            req.out_tokens.append(tok)
            self.stats["tokens_out"] += 1
            self.remaining[slot] -= 1
            if tok == self.eos_id or self.remaining[slot] <= 0:
                self._retire(req)
                self.active[slot] = None        # idles until wave drains
        self.tokens = next_tok[:, None]
        return sum(r is not None for r in self.active)


# -- continuous (per-slot) batching -------------------------------------------


class ContinuousEngine(_EngineBase):
    """Slot-level continuous batching with a device-resident decode
    loop. ``decode_chunk`` is the scheduling quantum: admissions and
    retirements happen between chunks; within a chunk the device runs
    the decode+sample steps and one (N, B) token block comes back."""
    kind = "continuous"

    def __init__(self, model, params, *, decode_chunk: int = 8,
                 top_k: int = 0, top_p: float = 0.0, seed: int = 0,
                 batch_admit: bool = True, overlap_admission: bool = False,
                 capture_logprobs: bool = False, **kw):
        super().__init__(model, params, **kw)
        self.decode_chunk = decode_chunk
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.batch_admit = batch_admit
        # overlap admission prefill with the decode chunk: after the
        # chunk is enqueued (before its blocking host read), queued
        # requests prefill into batch-1 scratch caches; they splice into
        # slots at the next chunk boundary. Same tokens as serial
        # batch-1 admission: per-rid streams and exact right-padded
        # prefill do not depend on placement or timing.
        self.overlap_admission = overlap_admission
        self._prepped: deque = deque()     # (req, scratch cache, logits)
        # RL rollout mode: each sampled token's log-prob comes back with
        # the chunk's token block (one more (N + 1, B) fp32 read)
        self.capture_logprobs = capture_logprobs
        dev, b = self.device, self.slots
        self.cache = self._make_cache()
        self.tokens = torch.full((b, 1), self.pad_id, dtype=torch.int32,
                                 device=dev)
        self.done = torch.ones((b,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.temps = torch.zeros((b,), dtype=torch.float32, device=dev)
        # first token of each slot admitted since the last drain (-1: none);
        # read back with the next chunk's token block
        self.first = torch.full((b,), -1, dtype=torch.int32, device=dev)
        self.first_lp = torch.zeros((b,), dtype=torch.float32, device=dev)
        # per-slot sampling stream of the request it holds (None: greedy)
        self._gens: list[torch.Generator | None] = [None] * b
        self.stats["decode_chunks"] = 0
        self.stats["prefills"] = 0
        self.stats["admit_batch_max"] = 0

    def _make_cache(self):
        """The engine's B-slot cache (the paged engine builds a pool)."""
        return self.model.init_cache(self.slots, self.shape)

    def _waiting(self) -> bool:
        return bool(self.queue or self._prepped)

    # -- device-side pieces ---------------------------------------------------

    def _noise(self) -> torch.Tensor | None:
        """(B, V) Gumbel draws for the sampled slots (zeros elsewhere);
        each sampled slot advances only its own request's stream."""
        if not any(g is not None for g in self._gens):
            return None
        vocab = self.cfg.padded_vocab
        noise = torch.zeros((self.slots, vocab), device=self.device)
        for s, g in enumerate(self._gens):
            if g is not None:
                noise[s] = gumbel(g, vocab, self.device)
        return noise

    def _chunk(self, n: int):
        """N decode+sample steps; returns the (N, B) sampled-token block
        (-1 for slots already done at step start) and, when capturing,
        the (N, B) fp32 log-probs of those tokens (0 where -1), else
        None. No host read."""
        toks = torch.empty((n, self.slots), dtype=torch.int32,
                           device=self.device)
        lps = torch.zeros((n, self.slots), device=self.device) \
            if self.capture_logprobs else None
        for t in range(n):
            logits, self.cache = self.model.decode(self.params, self.tokens,
                                                   self.cache)
            nxt = sample_tokens(logits, self.temps, self._noise(),
                                self.top_k, self.top_p)
            self.remaining -= (~self.done).to(torch.int32)
            newly = ~self.done & ((nxt == self.eos_id)
                                  | (self.remaining <= 0))
            toks[t] = torch.where(self.done, -1, nxt)
            if lps is not None:
                lps[t] = torch.where(self.done, 0.0,
                                     chosen_logprob(logits, nxt, self.temps))
            self.done |= newly
            self.tokens = nxt[:, None]
        return toks, lps

    # -- host-side scheduler --------------------------------------------------

    def _admit(self) -> None:
        """Fill every free slot from the queue. With ``batch_admit`` the
        waiting requests prefill in ONE bucketed call (batch padded to a
        power of two with throwaway rows); rows never interact, so each
        row's cache and logits equal a batch-1 prefill's."""
        free = [s for s in range(self.slots) if self.active[s] is None]
        while free and self._prepped:       # overlap-prefilled splice
            req, sub, logits = self._prepped.popleft()
            self._install(req, free.pop(0), sub, 0, logits)
        n = min(len(free), len(self.queue))
        if n == 0:
            return
        reqs = [self.queue.popleft() for _ in range(n)]
        groups = [reqs] if self.batch_admit else [[r] for r in reqs]
        taken = 0
        for grp in groups:
            self._admit_group(grp, free[taken:taken + len(grp)])
            taken += len(grp)

    def _prep_admissions(self) -> None:
        """Prefill queued requests (batch 1) while the decode chunk is
        still in flight: called between enqueuing the chunk and its
        blocking host read. The results wait in ``_prepped`` and splice
        at the next chunk boundary."""
        while self.queue and len(self._prepped) < self.slots:
            req = self.queue.popleft()
            self._check_prompt(req)
            n = len(req.prompt)
            tokens = np.full((1, self._padded_len(n)), self.pad_id, np.int32)
            tokens[0, :n] = req.prompt
            self.stats["prefills"] += 1
            logits, sub = self._prefill(tokens, np.array([n], np.int32))
            self._prepped.append((req, sub, logits))

    def _admit_group(self, reqs: list, slots: list) -> None:
        for req in reqs:
            self._check_prompt(req)
        nb = bucket_batch(len(reqs))
        padded = self._padded_len(max(len(r.prompt) for r in reqs))
        tokens = np.full((nb, padded), self.pad_id, np.int32)
        plen = np.ones((nb,), np.int32)    # dummy rows: 1-token pads
        for i, r in enumerate(reqs):
            tokens[i, :len(r.prompt)] = r.prompt         # RIGHT-pad
            plen[i] = len(r.prompt)
        self.stats["prefills"] += 1
        self.stats["admit_batch_max"] = max(
            self.stats["admit_batch_max"], len(reqs))
        logits, sub = self._prefill(tokens, plen)
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            self._install(req, slot, sub, i, logits[i:i + 1])

    def _install(self, req: Request, slot: int, sub, row: int,
                 logits: torch.Tensor) -> None:
        """Copy row ``row`` of every cache leaf of the prefilled ``sub``
        (the KV stack and the dense prefix layers', an SSM's states and
        conv rings) into ``slot``, then reset the slot's state
        (``_admit_state``)."""
        for big, small in zip(attn.kv_leaves(self.cache),
                              attn.kv_leaves(sub), strict=True):
            big.k[..., slot, :, :, :] = small.k[..., row, :, :, :]
            big.v[..., slot, :, :, :] = small.v[..., row, :, :, :]
            big.length[..., slot] = small.length[..., row]
        copy_state_rows(self.cache, sub, slot, row)
        self._admit_state(req, slot, logits)

    def _admit_state(self, req: Request, slot: int,
                     logits: torch.Tensor) -> None:
        """Post-splice half of admission: sample the first token from the
        (1, V) last-prompt-token ``logits`` and reset the slot's device
        state (shared by the dense splice and the paged engine's
        block-table paths)."""
        temp = float(req.temperature)
        gen = request_generator(self.seed, req.rid, self.device) \
            if temp > 0 else None
        noise = None if gen is None else \
            gumbel(gen, logits.shape[-1], self.device)[None]
        temps = torch.full((1,), temp, device=self.device)
        first = sample_tokens(logits, temps, noise, self.top_k,
                              self.top_p)
        if self.capture_logprobs:
            self.first_lp[slot] = chosen_logprob(logits, first, temps)[0]
        first = first[0]
        budget = self._budget(req) - 1
        self.tokens[slot, 0] = first
        self.done[slot] = True if budget <= 0 else first == self.eos_id
        self.remaining[slot] = budget
        self.temps[slot] = temp
        self.first[slot] = first
        self._gens[slot] = gen
        self.active[slot] = req
        self.stats["admitted"] += 1

    def _release(self, slot: int, req: Request) -> None:
        self._retire(req)
        self.active[slot] = None
        self._gens[slot] = None
        self._release_slot(slot)

    def _drain(self, first_np: np.ndarray, toks_np: np.ndarray,
               lps_np: np.ndarray | None = None) -> None:
        """Append the read-back block to the active requests: row 0 of
        ``lps_np`` holds the first tokens' log-probs, row t + 1 step
        t's (None: no capture)."""
        now = time.perf_counter()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            budget = self._budget(req)
            if first_np[slot] >= 0:
                first = int(first_np[slot])
                req.out_tokens.append(first)
                if lps_np is not None:
                    req.out_logprobs.append(float(lps_np[0, slot]))
                req.t_first = now
                self.stats["tokens_out"] += 1
                if first == self.eos_id or len(req.out_tokens) >= budget:
                    self._release(slot, req)
                    continue
            for t in range(toks_np.shape[0]):
                tok = int(toks_np[t, slot])
                if tok < 0:      # slot was done before this step
                    break
                req.out_tokens.append(tok)
                if lps_np is not None:
                    req.out_logprobs.append(float(lps_np[t + 1, slot]))
                self.stats["tokens_out"] += 1
                if tok == self.eos_id or len(req.out_tokens) >= budget:
                    self._release(slot, req)
                    break

    # -- scheduler seams (the paged engine overrides them) --------------------

    def _release_slot(self, slot: int) -> None:
        """Called when ``slot`` retires: the paged engine drops its block
        refs here."""

    def _before_chunk(self) -> None:
        """Called after admission, before the decode chunk is enqueued:
        the paged engine's copy-on-write fork point."""

    def _after_chunk(self, n: int) -> None:
        """Called after the chunk's host read, when every slot's cache
        length has advanced by ``n``."""

    def step(self) -> int:
        """One scheduling quantum: admit into free slots, run one decode
        chunk on the device, read its token block back (the single
        device-to-host transfer), retire finished requests."""
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        self._before_chunk()
        n = self.decode_chunk
        toks, lps = self._chunk(n)
        if self.overlap_admission:
            # the chunk is enqueued but not read back: admission
            # prefills ride the gap
            self._prep_admissions()
        block = torch.cat([self.first[None], toks])
        lps_np = None
        if lps is not None:
            # one transfer: the fp32 log-probs ride beside the int32
            # tokens as their bits, split again on the host
            lp = torch.cat([self.first_lp[None], lps]).view(torch.int32)
            both = torch.cat([block, lp], dim=1).cpu().numpy()
            block, lps_np = both[:, :self.slots], \
                both[:, self.slots:].view(np.float32)
        else:
            block = block.cpu().numpy()
        self.first.fill_(-1)
        self.stats["host_syncs"] += 1
        self.stats["decode_chunks"] += 1
        self.stats["decode_steps"] += n
        self.stats["total_slot_steps"] += n * self.slots
        self.stats["busy_slot_steps"] += int((block[1:] >= 0).sum())
        self._after_chunk(n)
        self._drain(block[0], block[1:], lps_np)
        return sum(r is not None for r in self.active)


def make_engine(kind: str, model, params, **kw):
    if kind == "wave":
        for k in ("decode_chunk", "top_k", "top_p", "seed", "batch_admit",
                  "overlap_admission"):
            kw.pop(k, None)
        return WaveEngine(model, params, **kw)
    if kind == "continuous":
        return ContinuousEngine(model, params, **kw)
    if kind == "paged":
        from repro_torch.serving.paging import PagedEngine
        return PagedEngine(model, params, **kw)
    raise ValueError(f"unknown engine kind {kind!r}")
