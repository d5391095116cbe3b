"""Exponential-backoff retry with jitter and a total deadline.

PyTorch port's copy of ``mpi4jax_tpu/resilience/retry.py``.  Built for the
rendezvous of ``init_distributed`` (``parallel/mesh.py``: ranks race the
store's server at job start, and transient refusals are the norm), but
generic: any callable whose failures are transient.

Full-jitter backoff (sleep ~ U(0, min(base * factor^n, max_delay))): the
standard cure for reconnection stampedes when many workers retry the
same server.  :func:`backoff_delay` is the pure ceiling the jitter draws
under.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["backoff_delay", "retry_with_backoff"]

# transient-looking failure classes for a network rendezvous; TypeError /
# ValueError and friends (programming errors) propagate immediately
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    ConnectionError,
    OSError,
    RuntimeError,
    TimeoutError,
)


def backoff_delay(attempt: int, *, base_delay: float = 1.0,
                  factor: float = 2.0, max_delay: float = 30.0) -> float:
    """The backoff CEILING after failed attempt ``attempt`` (1-based):
    ``min(base_delay * factor**(attempt - 1), max_delay)``.

    This is the explicit cap the full-jitter sleep draws under —
    ``U(0, backoff_delay(n))`` — so the jitter bound is pure and
    testable: no sleep ever exceeds ``max_delay`` regardless of how
    many attempts have failed (``factor**n`` overflows long before an
    unbounded ceiling would matter; the min saturates first).
    """
    if attempt < 1:
        raise ValueError(f"attempt must be >= 1, got {attempt}")
    if base_delay < 0:
        raise ValueError(f"base_delay must be >= 0, got {base_delay}")
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    if max_delay <= 0:
        raise ValueError(f"max_delay must be positive, got {max_delay}")
    # compare in log space first: factor ** (attempt - 1) overflows to
    # inf for large attempt counts, and inf * 0.0 (base_delay 0) is NaN
    if base_delay == 0:
        return 0.0
    try:
        raw = base_delay * factor ** (attempt - 1)
    except OverflowError:
        return max_delay
    return min(raw, max_delay)


def retry_with_backoff(
    fn: Callable,
    *,
    what: str = "operation",
    deadline: float = 300.0,
    max_attempts: Optional[int] = None,
    base_delay: float = 1.0,
    max_delay: float = 30.0,
    factor: float = 2.0,
    jitter: bool = True,
    retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE,
    giveup: Optional[Callable[[BaseException], bool]] = None,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
):
    """Call ``fn`` until it succeeds, a non-retryable error escapes, the
    total ``deadline`` (seconds) elapses, or ``max_attempts`` calls have
    failed (``None``/0 = attempts bounded only by the deadline).

    On either bound, raises ``RuntimeError`` naming ``what``, the attempt
    count, the elapsed time, and the total time spent sleeping between
    attempts, chained from the last underlying error — the "clear error
    at the deadline" a stuck bootstrap owes its operator (a large waited
    fraction says the budget went to backoff; a small one says ``fn``
    itself is slow).  ``giveup(exc) -> True`` re-raises immediately even
    for a retryable class (escape hatch for permanent failures that
    share an exception type with transient ones).  ``sleep``/``clock``
    are injectable for tests.

    Each sleep is full-jitter — drawn uniformly from
    ``[0, backoff_delay(attempt))`` — and never extends past the
    deadline, so the promised failure time holds exactly.
    """
    if deadline <= 0:
        raise ValueError(f"deadline must be positive, got {deadline}")
    if max_attempts is not None and max_attempts < 0:
        raise ValueError(f"max_attempts must be >= 0, got {max_attempts}")
    # validate the backoff shape up front: a bad factor must fail the
    # FIRST call loudly, not attempt 40 sleeps in
    backoff_delay(1, base_delay=base_delay, factor=factor,
                  max_delay=max_delay)
    start = clock()
    attempt = 0
    waited = 0.0
    while True:
        try:
            return fn()
        except retryable as e:
            if giveup is not None and giveup(e):
                raise
            attempt += 1
            elapsed = clock() - start
            if max_attempts and attempt >= max_attempts:
                raise RuntimeError(
                    f"{what} failed after {attempt} attempt(s) over "
                    f"{elapsed:.1f}s ({waited:.1f}s of it waiting between "
                    f"attempts; max_attempts {max_attempts}); last "
                    f"error: {type(e).__name__}: {e}"
                ) from e
            if elapsed >= deadline:
                raise RuntimeError(
                    f"{what} failed after {attempt} attempt(s) over "
                    f"{elapsed:.1f}s ({waited:.1f}s of it waiting between "
                    f"attempts; deadline {deadline:g}s); last error: "
                    f"{type(e).__name__}: {e}"
                ) from e
            delay = backoff_delay(attempt, base_delay=base_delay,
                                  factor=factor, max_delay=max_delay)
            if jitter:
                delay = random.uniform(0, delay)
            # never sleep past the deadline: fail at the promised time
            delay = min(delay, deadline - elapsed)
            if delay > 0:
                sleep(delay)
                waited += delay
