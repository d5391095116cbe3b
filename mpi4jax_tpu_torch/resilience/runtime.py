"""Resilience runtime glue: configuration and the per-op dispatch plan.

PyTorch counterpart of ``mpi4jax_tpu/resilience/runtime.py``.
``ops/_base.py:run_body``, the point every op goes through, asks
``plan_for(opname)`` what to do around each call.  The answer is ``None``
when every resilience feature is off (the default), and the op's body
runs as it is.  Otherwise a :class:`Plan` brackets the op with host
calls, in the JAX package's order:

- ``before``: the fault-injection probe (delay, die, hang, corrupt;
  ``faultinject.py``), then the input numeric guard (``numerics.py``),
  then the watchdog arm (``watchdog.py``);
- ``disarm``: the watchdog disarm, when the op returns or raises;
- ``after``: the output numeric guard.

Configuration layers: the programmatic overrides (``set_*``) shadow the
environment variables (``MPI4JAX_TPU_WATCHDOG_TIMEOUT``, ``_FAULT_SPEC``,
``_CHECK_NUMERICS``, ``utils/config.py``); each override bumps the
configuration epoch, so a pin captured before it goes stale
(``aot/invalidation.py``) and the plan memo is rebuilt.
``cache_token()`` is the effective configuration as one hashable value.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..utils import config
from .faultinject import (
    FaultClause,
    apply_corrupt,
    canonical_spec,
    parse_fault_spec,
    probe_host,
)

__all__ = [
    "Plan",
    "plan_for",
    "cache_token",
    "set_watchdog_timeout",
    "set_fault_spec",
    "set_check_numerics",
    "reset_overrides",
]

_UNSET = object()

_watchdog_override = _UNSET
_fault_override = _UNSET
_numerics_override = _UNSET


def set_watchdog_timeout(seconds) -> None:
    """Override ``MPI4JAX_TPU_WATCHDOG_TIMEOUT`` (``None``/0 disables).
    ``reset_overrides()`` returns control to the environment."""
    global _watchdog_override
    if not seconds:
        _watchdog_override = None
        config.bump_config_epoch()
        return
    val = float(seconds)
    # the environment path's validation: a negative timeout would declare
    # the first op hung at the monitor's first scan, NaN never expire
    if not (val > 0):
        raise ValueError(f"watchdog timeout must be > 0 seconds, got {seconds!r}")
    _watchdog_override = val
    config.bump_config_epoch()


def set_fault_spec(spec: Optional[str]) -> None:
    """Override ``MPI4JAX_TPU_FAULT_SPEC`` ('' or None disables).  The spec
    is validated at once (``ValueError`` on bad grammar)."""
    global _fault_override
    parse_fault_spec(spec or "")
    _fault_override = (spec or "").strip()
    config.bump_config_epoch()


def set_check_numerics(enabled) -> None:
    """Override ``MPI4JAX_TPU_CHECK_NUMERICS``."""
    global _numerics_override
    _numerics_override = bool(enabled)
    config.bump_config_epoch()


def reset_overrides() -> None:
    """Drop every programmatic override (the environment rules again)."""
    global _watchdog_override, _fault_override, _numerics_override
    _watchdog_override = _fault_override = _numerics_override = _UNSET
    config.bump_config_epoch()


def effective_watchdog_timeout() -> Optional[float]:
    if _watchdog_override is not _UNSET:
        return _watchdog_override
    return config.watchdog_timeout()


def effective_fault_clauses() -> Tuple[FaultClause, ...]:
    raw = _fault_override if _fault_override is not _UNSET else config.fault_spec()
    return parse_fault_spec(raw)


def effective_check_numerics() -> bool:
    if _numerics_override is not _UNSET:
        return _numerics_override
    return config.check_numerics()


def cache_token() -> tuple:
    """Hashable fingerprint of the effective resilience configuration: the
    timeout, the canonical fault spec, the numeric guards, the watchdog
    registry in use and the elastic epoch (0: the elastic layer is not
    ported, as ``aot/invalidation.py`` has it)."""
    from .watchdog import _force_fallback

    return (
        effective_watchdog_timeout(),
        canonical_spec(effective_fault_clauses()),
        effective_check_numerics(),
        _force_fallback,
        0,
    )


class Plan:
    """What to do around one op call."""

    __slots__ = ("clauses", "timeout", "numerics")

    def __init__(self, clauses, timeout, numerics):
        self.clauses = clauses      # ((bit, FaultClause), ...) matching this op
        self.timeout = timeout      # watchdog seconds or None
        self.numerics = numerics    # bool

    def before(self, mpi_name: str, call_id: str, comm, rank: int, arrays):
        """Probe, guard and arm; returns the op's inputs (corrupted where a
        corrupt clause fired)."""
        if self.clauses:
            mask = probe_host(self.clauses, mpi_name, rank)
            if mask:
                arrays = apply_corrupt(arrays, self.clauses, mask)
        if self.numerics:
            from .numerics import guard_values

            guard_values(mpi_name, call_id, rank, arrays, "input")
        if self.timeout is not None:
            from . import watchdog

            watchdog.arm(mpi_name, call_id, comm, rank, self.timeout)
        return arrays

    def disarm(self, call_id: str, rank: int) -> None:
        """Disarm the watchdog (when the op returns or raises)."""
        if self.timeout is not None:
            from . import watchdog

            watchdog.disarm(call_id, rank)

    def after(self, mpi_name: str, call_id: str, rank: int, results) -> None:
        """Guard the op's outputs."""
        if self.numerics:
            from .numerics import guard_values

            guard_values(mpi_name, call_id, rank, results, "output")


# one Plan per (service stamp, op name): a plan holds nothing that changes
# between calls, so the flags are parsed once per stamp
_plan_memo: list = [None, {}]
# its accounting (``ops/_base.py:cache_stats``)
_plan_stats = {"hits": 0, "misses": 0, "evictions": 0}


def plan_memo_stats() -> dict:
    """``{"hits", "misses", "evictions", "size"}`` of the plan memo."""
    return dict(_plan_stats, size=len(_plan_memo[1]))


def clear_plan_memo() -> None:
    """Empty the plan memo and zero its accounting."""
    _plan_memo[0] = None
    _plan_memo[1] = {}
    for k in _plan_stats:
        _plan_stats[k] = 0


def plan_for(opname: str) -> Optional[Plan]:
    """The resilience plan of one op call, or ``None`` when every feature
    is off."""
    stamp = config.service_stamp()
    if _plan_memo[0] != stamp:
        _plan_stats["evictions"] += len(_plan_memo[1])
        _plan_memo[1] = {}
        _plan_memo[0] = stamp
    memo = _plan_memo[1]
    if opname in memo:
        _plan_stats["hits"] += 1
        return memo[opname]
    _plan_stats["misses"] += 1
    timeout = effective_watchdog_timeout()
    numerics = effective_check_numerics()
    clauses = tuple(
        (bit, c)
        for bit, c in enumerate(effective_fault_clauses())
        if c.matches_op(opname)
    )
    plan = (None if timeout is None and not numerics and not clauses
            else Plan(clauses, timeout, numerics))
    memo[opname] = plan
    return plan
