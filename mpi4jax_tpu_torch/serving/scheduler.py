"""Continuous-batching request scheduler and the synthetic arrival trace.

PyTorch counterpart of ``mpi4jax_tpu/serving/scheduler.py``, pure
Python and the same code: ``poisson_trace`` draws from
``random.Random(seed)`` in the JAX package's order, so one seed gives
both packages the same trace, request for request.

The scheduler is the serving runtime's control plane: requests arrive on
a Poisson process, wait in a FIFO queue, are ADMITTED into free KV slots
between decode megasteps, decode as one bucketed batch, and are EVICTED
at the megastep boundary after they finish: iteration-level (continuous)
batching in the Orca/vLLM sense, where the batch changes between decode
steps instead of between whole batches.  The static baseline
(:class:`StaticScheduler`) is the classical alternative: a batch is
admitted only when the PREVIOUS batch has fully drained, so early
finishers idle their lanes until the batch's straggler completes.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .buckets import BucketTable
from .kvcache import SlotAllocator

__all__ = ["ContinuousScheduler", "Request", "Sequence", "StaticScheduler",
           "poisson_trace"]


@dataclass(frozen=True)
class Request:
    """One inference request of the synthetic trace."""

    rid: int
    arrival_s: float          # offset from trace start
    prompt: Tuple[int, ...]   # token ids
    max_new_tokens: int

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)


@dataclass
class Sequence:
    """A request holding a KV slot: the scheduler's unit of residency."""

    request: Request
    slot: int
    admitted_s: float
    generated: List[int] = field(default_factory=list)
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    preempt_readmissions: int = 0

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.request.max_new_tokens

    @property
    def tokens(self) -> Tuple[int, ...]:
        """Full committed token history (prompt + generated): what a
        survivor re-prefills from after an elastic drain."""
        return self.request.prompt + tuple(self.generated)

    def record(self, token_ids, now: float) -> None:
        """Append one megastep's worth of generated tokens, capped at the
        request budget (a megastep may overshoot by up to unroll-1
        tokens; the overshoot is computed but discarded: the price of
        boundary-only eviction)."""
        room = self.request.max_new_tokens - len(self.generated)
        take = list(token_ids)[:max(0, room)]
        if take and self.first_token_s is None:
            self.first_token_s = now
        self.generated.extend(int(t) for t in take)
        if self.done and self.finish_s is None:
            self.finish_s = now


def poisson_trace(n_requests: int, rate_rps: float, *, seed: int = 0,
                  prompt_len: Tuple[int, int] = (2, 8),
                  max_new: Tuple[int, int] = (4, 16),
                  long_frac: float = 0.0,
                  long_new: Tuple[int, int] = (0, 0),
                  vocab: int = 64) -> List[Request]:
    """A deterministic synthetic arrival trace: exponential interarrival
    times at ``rate_rps``, uniform prompt lengths and generation
    budgets, all drawn from one seeded generator: the same seed
    replays the same trace bit for bit.

    ``long_frac > 0`` makes the generation lengths HEAVY-TAILED: that
    fraction of requests draws its budget from ``long_new`` instead:
    the realistic regime (production length distributions are
    heavy-tailed) and the one where batch-level scheduling loses most:
    a static batch runs at its longest member's length while every
    short member's lane idles (Yu et al., OSDI '22)."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if not 0.0 <= long_frac <= 1.0:
        raise ValueError(f"long_frac must be in [0, 1], got {long_frac}")
    rng = random.Random(seed)
    out: List[Request] = []
    t = 0.0
    for rid in range(n_requests):
        t += rng.expovariate(rate_rps)
        plen = rng.randint(*prompt_len)
        budget = rng.randint(*(
            long_new if long_frac and rng.random() < long_frac else max_new
        ))
        out.append(Request(
            rid=rid,
            arrival_s=t,
            prompt=tuple(rng.randrange(1, vocab) for _ in range(plen)),
            max_new_tokens=budget,
        ))
    return out


class ContinuousScheduler:
    """Iteration-level batching against a slot budget and a bucket table.

    The engine drives it strictly at megastep boundaries::

        sched.offer(trace, now)          # move arrivals into the queue
        new = sched.admit(now)           # -> sequences to prefill
        ...decode megastep...
        done = sched.finish_ready(now)   # evict finished, free slots

    Admission is FIFO and bounded by (a) free KV slots and (b) the
    bucket table's ``max_batch`` residency cap.  ``decode_bucket()``
    maps the live batch to its padded program shape.
    """

    continuous = True

    def __init__(self, table: BucketTable, alloc: SlotAllocator):
        self.table = table
        self.alloc = alloc
        self.waiting: deque = deque()
        self.running: List[Sequence] = []
        self.finished: List[Sequence] = []
        self._offered = 0

    # -- arrivals ----------------------------------------------------------

    def offer(self, trace: List[Request], now: float) -> int:
        """Move every not-yet-offered request with ``arrival_s <= now``
        into the waiting queue (the trace must be arrival-ordered).
        Returns how many arrived."""
        n = 0
        while self._offered < len(trace) \
                and trace[self._offered].arrival_s <= now:
            self.waiting.append(trace[self._offered])
            self._offered += 1
            n += 1
        return n

    def next_arrival_s(self, trace: List[Request]) -> Optional[float]:
        if self._offered >= len(trace):
            return None
        return trace[self._offered].arrival_s

    # -- admission / eviction ---------------------------------------------

    def _admissible(self) -> bool:
        return (bool(self.waiting)
                and len(self.running) < self.table.max_batch
                and self.alloc.free() > 0)

    def admit(self, now: float) -> List[Sequence]:
        """FIFO admission at a megastep boundary; assigns KV slots."""
        new: List[Sequence] = []
        while self._admissible():
            req = self.waiting.popleft()
            seq = Sequence(request=req, slot=self.alloc.alloc(),
                           admitted_s=now)
            self.running.append(seq)
            new.append(seq)
        return new

    def finish_ready(self, now: float) -> List[Sequence]:
        """Evict every finished sequence, freeing its slot."""
        done = [s for s in self.running if s.done]
        for s in done:
            if s.finish_s is None:
                s.finish_s = now
            self.alloc.free_slot(s.slot)
            self.running.remove(s)
            self.finished.append(s)
        return done

    def decode_bucket(self) -> Optional[int]:
        """The padded program shape of the current live batch (``None``
        when nothing is running)."""
        if not self.running:
            return None
        return self.table.bucket_for(len(self.running))

    def idle(self, trace: List[Request]) -> bool:
        """Nothing running, nothing waiting, nothing left to arrive."""
        return (not self.running and not self.waiting
                and self._offered >= len(trace))

    # -- elastic drain support --------------------------------------------

    def requeue_running(self) -> List[Sequence]:
        """Pull every in-flight sequence out of its slot (world change:
        the KV pool is rebuilt on the surviving ranks).  The sequences
        keep their token history — the engine re-prefills them from
        ``Sequence.tokens`` — and re-enter the running set with FRESH
        slots, ahead of the waiting queue (they are the oldest work)."""
        moved = list(self.running)
        for s in moved:
            self.alloc.free_slot(s.slot)
        self.running = []
        return moved

    def readmit(self, seqs: List[Sequence]) -> List[Sequence]:
        """Re-seat requeued sequences after a world change (fresh
        slots).  Caller guarantees capacity: the slot pool was rebuilt
        empty and the running set cannot exceed max_batch by
        construction."""
        for s in seqs:
            s.slot = self.alloc.alloc()
            s.preempt_readmissions += 1
            self.running.append(s)
        return seqs


class StaticScheduler(ContinuousScheduler):
    """The batch-level baseline: a new batch is admitted ONLY when the
    previous one has fully drained — no admission while anything runs,
    which is exactly the lane idling continuous batching removes."""

    continuous = False

    def admit(self, now: float) -> List[Sequence]:
        # a closed batch admits nothing until it fully drains; once
        # empty, one whole batch is admitted in a single boundary (the
        # parent's loop fills up to max_batch / free slots as usual)
        if self.running:
            return []
        return super().admit(now)
