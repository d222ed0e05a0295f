"""Serving runtime: slot-based continuous batching over bucketed shapes.

``max_batch`` persistent decode slots, an admission queue with arrival
times, and retire-and-refill on every decode step: a finished request
frees its slot at once, and the scheduler prefills newly admitted
requests into free slots while occupied slots keep decoding.

Shapes are bucketed as in the JAX reference:

  * prefill: (B = max_batch, S = next-pow2 prompt bucket), prompts
    right-padded, true lengths passed to ``model.prefill(lengths=...)``;
  * decode:  (B = max_batch, 1) every step, against the slot state from
    ``model.init_slot_state`` (per-slot ``pos``);
  * insert:  ``model.slot_update`` scatters a prefill's per-request state
    into slot indices; admission groups are padded with a sentinel slot
    that the scatter drops.

PyTorch runs eagerly, so the reference's trace-count rule (one compiled
program per bucket) takes the form of ``prefill_counts``: prefills per
bucket shape, every one at the fixed batch ``max_batch``.

Per-request outputs equal single-stream decoding (see
``tests/test_torch_serving.py`` and ``tests/test_torch_ssm.py``).
Speculative decoding, paged caches, snapshots, backpressure and the
serving mesh are not ported yet; :class:`ServeConfig` refuses their
knobs, and the model paged caches, naming the ROADMAP item.  The int8
cache (``cache_dtype="int8"`` or ``cache=CacheSpec(dtype="int8")``)
serves both families: the K/V cache of the dense family, the recurrent
state of the ssm family.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import CacheSpec
from repro_torch.models.model_zoo import Model

# knob -> the ROADMAP (queue 1) item that ports it
_LATER_KNOBS = {
    "spec_k": "12 (speculative decode)",
    "spec_k_max": "12 (speculative decode)",
    "spec_adaptive": "12 (speculative decode)",
    "drafter": "12 (speculative decode)",
    "num_blocks": "13 (paged cache)",
    "prefix_cache": "13 (paged cache and radix prefix cache)",
    "max_queue": "14 (backpressure)",
    "admission_policy": "14 (backpressure)",
    "snapshot_dir": "14 (snapshot and restore)",
    "snapshot_every": "14 (snapshot and restore)",
    "kill_at_step": "14 (fault injection)",
    "num_shards": "15 (serving mesh)",
    "prefill_workers": "15 (serving mesh)",
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The knobs of :class:`ServeEngine`, validated in one place.

    The first four and the cache format (``cache``, a :class:`CacheSpec`,
    or the legacy ``cache_dtype`` string; not both) are what this engine
    reads; a format the model cannot serve yet raises when the engine
    applies it.  The rest keep the JAX reference's names and defaults;
    setting one raises ``NotImplementedError`` naming the ROADMAP item
    that ports it.
    """

    max_batch: int = 8
    max_seq: int = 256
    greedy: bool = True
    min_bucket: int = 16
    spec_k: int = 0
    spec_k_max: Optional[int] = None
    spec_adaptive: bool = False
    drafter: Optional[Any] = None
    cache_dtype: Optional[str] = None
    cache: Optional[CacheSpec] = None
    num_blocks: Optional[int] = None
    prefix_cache: bool = True
    max_queue: Optional[int] = None
    admission_policy: str = "reject-new"
    snapshot_dir: Optional[str] = None
    snapshot_every: int = 0
    kill_at_step: Optional[int] = None
    num_shards: Optional[int] = None
    prefill_workers: int = 0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if f.name in _LATER_KNOBS and getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"ServeConfig.{f.name}={getattr(self, f.name)!r}: not "
                    f"ported yet (ROADMAP queue 1, item "
                    f"{_LATER_KNOBS[f.name]})")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if self.min_bucket < 1:
            raise ValueError(f"min_bucket must be >= 1, got "
                             f"{self.min_bucket}")
        if self.cache is not None and self.cache_dtype is not None:
            raise ValueError("cache (a CacheSpec) and the legacy "
                             "cache_dtype string are two spellings of the "
                             "same thing; pass exactly one")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32 tokens
    max_new_tokens: int = 16
    arrival_s: float = 0.0        # arrival offset from serve() start
    # per-request sampling params (engine greedy=True overrides all)
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => full distribution
    seed: int = 0
    output: Optional[np.ndarray] = None
    status: str = "pending"       # "done" once served
    submitted_at: float = 0.0     # absolute arrival time
    admitted_at: float = 0.0      # absolute prefill time
    done_at: float = 0.0


@dataclasses.dataclass
class _Slot:
    """Live decode-slot bookkeeping (host side)."""
    req: Request
    next_token: int               # last sampled token, fed next step
    produced: int                 # tokens emitted so far (incl. prefill's)
    tokens: List[int]
    rng: Optional[np.random.Generator]


def next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class ServeEngine:
    """Continuous-batching serve engine (slot scheduler, bucketed shapes)."""

    def __init__(self, model: Model, params,
                 config: Optional[ServeConfig] = None):
        config = config or ServeConfig()
        self.config = config
        # the cache format, as the reference applies it: the model with
        # its state stored as the config asks (int8: a bf16 K/V cache ~2x,
        # a float32 recurrent state ~4x smaller)
        if config.cache is not None:
            model = model.with_cache_spec(config.cache)
        elif config.cache_dtype is not None:
            model = model.with_cache_dtype(config.cache_dtype)
        self.model = model
        self.params = params
        self.device = model.device
        self.max_batch = config.max_batch
        self.max_seq = config.max_seq
        self.greedy = config.greedy
        self.min_bucket = config.min_bucket
        self.ops = model.cache_ops()
        # prompt buckets are powers of two; the largest is the largest
        # power of two that fits the slot cache
        self._bucket_cap = 1 << (self.max_seq.bit_length() - 1)
        self._state = None        # allocated on the first serve()
        self._slots: List[Optional[_Slot]] = [None] * self.max_batch
        # prefill bucket length -> prefills run at (max_batch, bucket)
        self.prefill_counts: collections.Counter = collections.Counter()
        self.metrics: Dict[str, float] = {
            "prefill_tokens": 0, "decode_tokens": 0, "decode_steps": 0,
            "prefill_s": 0.0, "decode_s": 0.0, "queue_wait_s": 0.0,
            "slot_occupancy": 0.0, "wall_s": 0.0, "tok_s": 0.0}
        # ("admit"|"retire", rid, slot, decode_step) for the last serve()
        self.events: List[tuple] = []
        self._occ_num = self._occ_den = 0
        self._wait_sum = 0.0
        self._n_done = 0

    # -- scheduling ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        return min(max(self.min_bucket, next_pow2(n)), self._bucket_cap)

    def _validate(self, requests: List[Request]) -> None:
        live = {s.req.rid for s in self._slots if s is not None}
        seen: set = set()
        for r in requests:
            if r.rid in seen or r.rid in live:
                raise ValueError(f"duplicate request id {r.rid}: request ids "
                                 f"key scheduling; give every request a "
                                 f"unique rid")
            seen.add(r.rid)
        for r in requests:
            need = len(r.prompt) + r.max_new_tokens
            if need > self.max_seq:
                raise ValueError(
                    f"request {r.rid}: prompt {len(r.prompt)} + max_new "
                    f"{r.max_new_tokens} exceeds max_seq {self.max_seq}; "
                    f"requests are never silently dropped")
            if len(r.prompt) > self._bucket_cap:
                raise ValueError(
                    f"request {r.rid}: prompt {len(r.prompt)} exceeds the "
                    f"largest prompt bucket ({self._bucket_cap}) for "
                    f"max_seq {self.max_seq}")
            if r.max_new_tokens < 1:
                raise ValueError(f"request {r.rid}: max_new_tokens < 1")
            if len(r.prompt) < 1:
                raise ValueError(f"request {r.rid}: empty prompt")
            vocab = self.model.cfg.vocab_size
            if np.any((r.prompt < 0) | (r.prompt >= vocab)):
                raise ValueError(f"request {r.rid}: token ids must lie in "
                                 f"[0, {vocab})")

    def _pull_logits(self, logits: torch.Tensor, sampling: bool):
        """Host view of a step's logits: greedy pulls only B ints (argmax on
        the device); only steps where a live request samples pull the full
        (B, vocab) float rows."""
        b = self.max_batch
        logits = logits.reshape(b, -1)
        if self.greedy or not sampling:
            return torch.argmax(logits, dim=-1).cpu().numpy(), None
        return None, logits.to(torch.float32).cpu().numpy()

    def _next_token(self, slot: _Slot, i: int, ids, rows) -> int:
        return (int(ids[i]) if rows is None
                else self._select_token(slot, rows[i]))

    def _dist(self, slot: _Slot, row: np.ndarray) -> np.ndarray:
        """The request's sampling distribution over one logits row
        (temperature + top_k)."""
        r = slot.req
        z = row.astype(np.float64) / max(r.temperature, 1e-6)
        k = min(int(r.top_k), z.size)   # top_k >= vocab == no filter
        if 0 < k < z.size:
            kth = np.partition(z, -k)[-k]
            z = np.where(z >= kth, z, -np.inf)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return p

    def _select_token(self, slot: _Slot, row: np.ndarray) -> int:
        if self.greedy or slot.req.temperature <= 0.0:
            return int(np.argmax(row))
        p = self._dist(slot, row)
        return int(slot.rng.choice(len(p), p=p))

    def _retire(self, i: Optional[int], slot: _Slot, done: List[Request]
                ) -> None:
        r = slot.req
        r.output = np.asarray(slot.tokens[:r.max_new_tokens], np.int32)
        r.done_at = time.monotonic()
        r.status = "done"
        done.append(r)
        self._n_done += 1
        self.events.append(("retire", r.rid, -1 if i is None else i,
                            int(self.metrics["decode_steps"])))
        if i is not None:
            self._slots[i] = None

    # -- admission -----------------------------------------------------------

    def _prefill_args(self, group: List[Request], free: List[int]):
        """Bucket-pad an admission group: (tokens, lengths, slots)."""
        b = self.max_batch
        bucket = self._bucket(max(len(r.prompt) for r in group))
        arr = np.zeros((b, bucket), np.int64)
        lengths = np.ones((b,), np.int64)       # dummy rows: length 1
        slots = np.full((b,), b, np.int64)      # sentinel: scatter drops
        for j, r in enumerate(group):
            arr[j, :len(r.prompt)] = r.prompt
            lengths[j] = len(r.prompt)
            slots[j] = free[j]
        return arr, lengths, slots

    def _admit(self, group: List[Request], free: List[int],
               done: List[Request]) -> None:
        """Prefill a bucket-padded admission group into free slots."""
        t0 = time.monotonic()
        arr, lengths, slots = self._prefill_args(group, free)
        self.prefill_counts[arr.shape[1]] += 1
        tokens = torch.from_numpy(arr).to(self.device)
        logits, sub = self.model.prefill(
            self.params, {"tokens": tokens}, headroom=0,
            lengths=torch.from_numpy(lengths).to(self.device))
        self._finish_admit(group, free, logits, sub, slots, done)
        self.metrics["prefill_s"] += time.monotonic() - t0

    def _finish_admit(self, group: List[Request], free: List[int], logits,
                      sub, slots: np.ndarray, done: List[Request]) -> None:
        """Insert prefilled sub-state into the slot batch + bookkeeping."""
        self._state = self.ops.slot_update(self._state, sub, slots)
        ids, rows = self._pull_logits(
            logits, any(r.temperature > 0.0 for r in group))
        now = time.monotonic()
        for j, r in enumerate(group):
            r.admitted_at = now
            self._wait_sum += max(0.0, now - r.submitted_at)
            self.metrics["prefill_tokens"] += len(r.prompt)
            self.events.append(("admit", r.rid, free[j],
                                int(self.metrics["decode_steps"])))
            rng = (np.random.default_rng([r.seed, r.rid])
                   if not self.greedy and r.temperature > 0.0 else None)
            slot = _Slot(req=r, next_token=0, produced=0, tokens=[], rng=rng)
            slot.next_token = self._next_token(slot, j, ids, rows)
            slot.tokens.append(slot.next_token)
            slot.produced = 1
            if slot.produced >= r.max_new_tokens:
                self._retire(None, slot, done)     # 1-token request
            else:
                self._slots[free[j]] = slot

    # -- decode ---------------------------------------------------------------

    def _plain_step(self, active: List[int], done: List[Request]) -> None:
        """One single-token decode step for every slot (fixed B)."""
        t0 = time.monotonic()
        b = self.max_batch
        tokens = np.zeros((b, 1), np.int64)
        for i in active:
            tokens[i, 0] = self._slots[i].next_token
        logits, self._state = self.model.decode_step(
            self.params, self._state,
            {"tokens": torch.from_numpy(tokens).to(self.device)})
        ids, rows = self._pull_logits(
            logits, any(self._slots[i].rng is not None for i in active))
        # the host pull above waits for the device, so this is step time
        self.metrics["decode_s"] += time.monotonic() - t0
        self.metrics["decode_steps"] += 1
        self.metrics["decode_tokens"] += len(active)
        self._occ_num += len(active)
        self._occ_den += b
        # retire-and-refill: a finished slot frees this very step
        for i in active:
            slot = self._slots[i]
            slot.next_token = self._next_token(slot, i, ids, rows)
            slot.tokens.append(slot.next_token)
            slot.produced += 1
            if slot.produced >= slot.req.max_new_tokens:
                self._retire(i, slot, done)

    # -- the loop -----------------------------------------------------------

    @torch.inference_mode()
    def serve(self, requests: List[Request]) -> List[Request]:
        """Run the trace to completion; returns requests in finish order.

        Requests become visible to the scheduler ``arrival_s`` seconds
        after the call; every request is served, and an over-budget
        request raises instead of being dropped.
        """
        self._validate(requests)
        if self._state is None:
            self._state = self.ops.init_slot_state(self.max_batch,
                                                   self.max_seq)
        self.events = []
        self._occ_num = self._occ_den = 0
        self._wait_sum = 0.0
        self._n_done = 0
        t0 = time.monotonic()
        for r in requests:
            r.submitted_at = t0 + r.arrival_s
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        waiting: collections.deque = collections.deque()
        done: List[Request] = []

        while pending or waiting or any(s is not None for s in self._slots):
            now_rel = time.monotonic() - t0
            while pending and pending[0].arrival_s <= now_rel:
                waiting.append(pending.popleft())
            free = [i for i, s in enumerate(self._slots) if s is None]
            group: List[Request] = []
            while waiting and len(group) < len(free):
                group.append(waiting.popleft())
            if group:
                self._admit(group, free, done)
            active = [i for i, s in enumerate(self._slots) if s is not None]
            if not active:
                if pending and not waiting:
                    # idle: wait for the next arrival
                    time.sleep(min(0.005, max(
                        0.0, pending[0].arrival_s - (time.monotonic() - t0))))
                continue
            self._plain_step(active, done)

        self.metrics["queue_wait_s"] = self._wait_sum / max(self._n_done, 1)
        self.metrics["slot_occupancy"] = self._occ_num / max(self._occ_den, 1)
        self.metrics["wall_s"] = time.monotonic() - t0
        self.metrics["tok_s"] = (
            sum(len(r.output) for r in done) / max(self.metrics["wall_s"],
                                                   1e-9))
        return done
