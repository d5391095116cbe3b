"""Pure fitting math: sweep rows in, tuned knob values out.

The port's own copy of ``mpi4jax_tpu/autotune/fit.py``, function for
function (the tests hold the two equal on the same rows): plain Python
over numbers, no file I/O, no environment reads.  The runner
(``autotune/runner.py``) feeds it from the sweeps of
``autotune/sweeps.py``:

- :func:`measured_crossover`: where measurement B first beats A over an
  ascending payload sweep, linearly interpolated;
- :func:`analytic_crossover`: the alpha-beta closed form of the
  ring/butterfly allreduce crossover on a k-rank group;
- :func:`pick_min`: argmin over candidate settings (fusion bucket bytes,
  overlap chunk counts);
- :func:`chunk_buckets`: per-payload chunk winners folded into the
  ``overlap_chunks`` bucket list of the ``mpx-tuning/1`` schema;
- :func:`auto_commit_interval`: the commit-interval math of
  ``elastic.run(commit_every='auto')``: the smallest interval that keeps
  the commit cost under a target fraction of the step time.
"""


from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

# auto-commit defaults: checkpoint overhead capped at 5% of step time
# (the classic rule of thumb; Young/Daly optimal intervals need a
# failure-rate estimate the store does not have), interval capped so a
# very fast packer can never push the replay window unbounded
DEFAULT_COMMIT_OVERHEAD = 0.05
MAX_COMMIT_INTERVAL = 1024


def measured_crossover(rows: Sequence[dict], size_key: str, a_key: str,
                       b_key: str, to_bytes: float = 1e6) -> Optional[int]:
    """Payload (bytes) where measurement ``b_key`` first beats
    ``a_key`` over an ascending size sweep, linearly interpolated
    between the straddling rows.  ``None`` when B never wins, a row
    lacks either timing, or the sweep is empty — the caller then leaves
    the knob untuned rather than guessing."""
    prev: Optional[Tuple[float, float]] = None
    for row in rows:
        a, b = row.get(a_key), row.get(b_key)
        if a is None or b is None:
            return None
        nbytes = row[size_key] * to_bytes
        delta = a - b  # > 0: B wins
        if delta >= 0:
            if prev is None:
                return int(nbytes)
            p_bytes, p_delta = prev
            span = delta - p_delta
            frac = (-p_delta / span) if span > 0 else 0.0
            return int(p_bytes + frac * (nbytes - p_bytes))
        prev = (nbytes, delta)
    return None


def analytic_crossover(alpha_us: float, gb_per_s: float,
                       k: int) -> Optional[int]:
    """Alpha-beta closed form of the ring/butterfly allreduce crossover
    on a ``k``-rank group of one link class.

    Butterfly: ``2·ceil(log2 k)`` rounds shipping the full payload each
    (``t = 2L·alpha + 2L·s/bw``); ring: ``2·(k-1)`` chunk rounds
    (``t = 2(k-1)·alpha + 2·(k-1)/k·s/bw``).  Equating and solving for
    ``s`` gives the payload where the ring's byte advantage pays for
    its extra latency rounds::

        s* = (2(k-1) - 2L) · alpha · bw / (2L - 2(k-1)/k)

    with ``bw`` in bytes/us (``gb_per_s * 1e3``).  ``None`` below the
    ring's minimum group size (k < 4: the ring never wins —
    ops/_algos.RING_MIN_GROUP) or on degenerate parameters."""
    if k < 4 or alpha_us < 0 or gb_per_s <= 0:
        return None
    L = (k - 1).bit_length()  # ceil(log2 k)
    lat_gap = 2 * (k - 1) - 2 * L        # extra ring latency rounds
    byte_gap = 2 * L - 2 * (k - 1) / k   # butterfly's extra bytes factor
    if byte_gap <= 0:
        return None
    s = lat_gap * alpha_us * (gb_per_s * 1e3) / byte_gap
    return max(1, int(math.ceil(s)))


def pick_min(rows: Sequence[dict], candidate_key: str,
             metric_key: str) -> Optional[Tuple[object, float]]:
    """The candidate with the smallest metric: ``(candidate, metric)``,
    ties broken toward the earlier row (sweeps list the default-ish
    candidates first).  ``None`` on an empty sweep or missing
    metrics."""
    best = None
    for row in rows:
        cand, metric = row.get(candidate_key), row.get(metric_key)
        if cand is None or metric is None:
            return None
        if best is None or metric < best[1]:
            best = (cand, float(metric))
    return best


def chunk_buckets(winners: Sequence[Tuple[int, int]]) -> object:
    """Fold per-payload overlap-chunk winners ``[(payload_bytes,
    chunks), ...]`` into the schema's ``overlap_chunks`` value: a plain
    int when one chunk count wins everywhere, else the ascending bucket
    list with the largest payload's winner as the open-ended tail.
    Adjacent buckets with the same winner merge."""
    if not winners:
        return None
    ordered = sorted(winners)
    counts = {c for _, c in ordered}
    if len(counts) == 1:
        return int(ordered[0][1])
    buckets: List[dict] = []
    for nbytes, chunks in ordered:
        if buckets and buckets[-1]["chunks"] == chunks:
            buckets[-1]["max_bytes"] = int(nbytes)
            continue
        buckets.append({"max_bytes": int(nbytes), "chunks": int(chunks)})
    buckets[-1]["max_bytes"] = None  # largest measured payload: open tail
    return buckets


def auto_commit_interval(step_time_s: float, commit_cost_s: float,
                         target_overhead: Optional[float] = None,
                         max_interval: int = MAX_COMMIT_INTERVAL) -> int:
    """Steps between commits so that checkpoint overhead stays at or
    under ``target_overhead`` of compute: the smallest ``n`` with
    ``commit_cost <= target · n · step_time``, clamped to
    ``[1, max_interval]``.  A non-positive or unmeasurable step time
    yields the conservative 1 (commit every step — the pre-autotune
    behavior)."""
    if target_overhead is None:
        target_overhead = DEFAULT_COMMIT_OVERHEAD
    if step_time_s <= 0 or commit_cost_s < 0 or target_overhead <= 0:
        return 1
    n = math.ceil(commit_cost_s / (target_overhead * step_time_s))
    return max(1, min(int(n), max_interval))
