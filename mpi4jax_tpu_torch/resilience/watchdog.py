"""Collective watchdog: turn silent hangs into loud, diagnosable deaths.

PyTorch counterpart of ``mpi4jax_tpu/resilience/watchdog.py``.  A dead
or stalled rank leaves every other rank blocked in its next exchange
(gloo's own timeout is minutes).  With ``MPI4JAX_TPU_WATCHDOG_TIMEOUT``
set, the dispatch point (``ops/_base.py:run_body``) arms a registry entry
before each op's exchange and disarms it when the op returns, on every
exit path; an op in flight longer than the timeout makes the monitor dump
every in-flight op of this process (op name, call id, comm axes, elapsed)
and kill the process, so that the launcher sees a death instead of a
hang.

Two registries, as in the JAX package:

- **native** (``csrc/host_hooks.cc``): registry and monitor thread in
  C++, which keep running while every Python thread is wedged; used
  whenever the hooks library builds (``native.py``);
- **Python** (this module): a registry watched by a daemon thread, used
  without the library or under ``force_python_fallback(True)``; its
  expiry handler is pluggable (``set_on_timeout``) and
  ``suspend_expiries`` holds its expiries off.

Only the Python monitor tells the health plane of an expiry
(``telemetry/health.py:on_watchdog_expiry``: a stall incident and a
postmortem bundle); the C++ one aborts in C++ and writes no bundle, as in
the JAX package, so a run that wants its survivors' bundles routes the
watchdog through the Python registry (``force_python_fallback(True)``).

``drain_registry`` empties both.  Arm and disarm are plain host calls
around the op: the port runs its ops eagerly, so program order brackets
them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

__all__ = [
    "arm",
    "disarm",
    "inflight_snapshot",
    "registry_empty",
    "set_on_timeout",
    "drain_registry",
    "suspend_expiries",
]

_POLL_INTERVAL = 0.1

# nesting depth of suspend_expiries() windows: while > 0 the monitor
# keeps tracking in-flight ops but treats none as expired.  Planned
# elastic reconfigurations (grow admission, graceful drain) hold the
# window open across their re-bootstrap + restore exchange — seconds of
# legitimate cross-rank skew that must not read as a hang.
_suspend_lock = threading.Lock()
_suspended = 0


class suspend_expiries:
    """Context manager: no watchdog expiry fires while any window is
    open (arms and disarms still track normally, so coverage resumes the
    moment the window closes)."""

    def __enter__(self):
        global _suspended
        with _suspend_lock:
            _suspended += 1
        return self

    def __exit__(self, *exc):
        global _suspended
        with _suspend_lock:
            _suspended = max(0, _suspended - 1)
        return False


def expiries_suspended() -> bool:
    with _suspend_lock:
        return _suspended > 0


def _telemetry_incident(meter_name, name, rank, detail=""):
    """Mirror a watchdog lifecycle event into the telemetry layer via the
    shared incident helper."""
    from ..telemetry import journal

    journal.incident(meter_name, name, rank, detail)


def _default_on_timeout(entries, expired):
    """Dump per-rank in-flight diagnostics, then die via the abort path."""
    from .. import native

    for e in entries:
        native.host_line(
            e["rank"],
            f"WATCHDOG | in-flight: {e['opname']} (call {e['call_id']}, "
            f"axes={e['axes']}, elapsed {e['elapsed']:.2f}s)",
        )
    native.host_fatal(
        expired["rank"],
        f"collective watchdog: {expired['opname']} exceeded "
        f"{expired['timeout']:g}s (call {expired['call_id']}, "
        f"axes={expired['axes']})",
    )


class _Registry:
    """In-flight op registry + monitor thread (the Python fallback path).

    Keys are ``(call_id, rank)`` with a FIFO of start times per key — a trace
    site inside ``lax.fori_loop`` fires once per iteration with the same call
    id, and the data dependencies order iteration N+1's arm after iteration
    N's collective but not after N's disarm (the same aliasing the native
    trace hooks handle, csrc/host_hooks.cc ``begin_times``).
    """

    def __init__(self, on_timeout: Optional[Callable] = None,
                 clock=time.monotonic):
        self.lock = threading.Lock()
        self.entries = {}  # (call_id, rank) -> deque of (opname, axes, start, timeout)
        self.clock = clock
        self.on_timeout = on_timeout or _default_on_timeout
        self._thread = None

    def arm(self, opname: str, call_id: str, rank: int, axes: str,
            timeout: float) -> None:
        with self.lock:
            self.entries.setdefault((call_id, int(rank)), deque()).append(
                (opname, axes, self.clock(), float(timeout))
            )
            self._ensure_thread_locked()

    def disarm(self, call_id: str, rank: int) -> None:
        key = (call_id, int(rank))
        with self.lock:
            dq = self.entries.get(key)
            if dq:
                dq.popleft()
                if not dq:
                    del self.entries[key]

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._monitor, name="mpi4jax_tpu-watchdog", daemon=True
            )
            self._thread.start()

    def snapshot(self):
        """Diagnostic view of every in-flight op: list of dicts with opname,
        call_id, rank, axes, elapsed, timeout."""
        now = self.clock()
        with self.lock:
            return [
                {
                    "opname": opname, "call_id": call_id, "rank": rank,
                    "axes": axes, "elapsed": now - start, "timeout": timeout,
                }
                for (call_id, rank), dq in self.entries.items()
                for (opname, axes, start, timeout) in dq
            ]

    def check_expired(self):
        """One monitor scan; returns the expired snapshot entry or None
        (always None inside a ``suspend_expiries`` window — planned
        elastic reconfiguration, not a hang)."""
        if expiries_suspended():
            return None
        for e in self.snapshot():
            if e["elapsed"] > e["timeout"]:
                return e
        return None

    def empty(self) -> bool:
        with self.lock:
            return not self.entries

    def drain(self) -> int:
        """Forget every in-flight entry (epoch revocation: arms from
        collectives of a revoked world must not fire into the recovered
        job).  Returns the number of entries dropped."""
        with self.lock:
            n = sum(len(dq) for dq in self.entries.values())
            self.entries.clear()
        return n

    def drain_expired(self) -> int:
        """Forget only the entries whose timeout has elapsed (a claimed
        expiry): un-expired arms of unrelated concurrent collectives keep
        their coverage.  Returns the number of entries dropped."""
        now = self.clock()
        dropped = 0
        with self.lock:
            for key in list(self.entries):
                dq = self.entries[key]
                kept = deque(e for e in dq if now - e[2] <= e[3])
                dropped += len(dq) - len(kept)
                if kept:
                    self.entries[key] = kept
                else:
                    del self.entries[key]
        return dropped

    def _monitor(self) -> None:
        while True:
            time.sleep(_POLL_INTERVAL)
            expired = self.check_expired()
            if expired is not None:
                # the incident is journalled HERE, before the handler
                # runs: a handler that recovers (or kills) the process
                # must not be able to lose the expiry record, and a
                # replacement handler need not re-implement it
                _telemetry_incident(
                    "watchdog.expiries", "watchdog_expired",
                    expired["rank"],
                    f"{expired['opname']} call {expired['call_id']} "
                    f"exceeded {expired['timeout']:g}s",
                )
                # the health plane's stall incident and postmortem bundle,
                # while the registry and the flight ring still show the
                # stuck op, also before a handler can abort (a no-op
                # unless MPI4JAX_TPU_HEALTH=on; it must not stop the
                # monitor)
                try:
                    from ..telemetry import health as _health

                    _health.on_watchdog_expiry(expired)
                except Exception:
                    pass
                self.on_timeout(self.snapshot(), expired)
                # only reachable with a non-fatal handler (the default
                # aborts the process): drop the EXPIRED entries — healthy
                # concurrent arms keep their coverage — and keep
                # monitoring; the handler's recovery (e.g. an elastic
                # shrink, which drains everything via revoke_epoch)
                # re-arms collectives of the NEW epoch under fresh entries
                self.drain_expired()


_registry = _Registry()


def registry_empty() -> bool:
    """True when no op is in flight in the Python-fallback registry."""
    return _registry.empty()


def inflight_snapshot():
    """Current in-flight ops in the Python-fallback registry (diagnostics)."""
    return _registry.snapshot()


# when True, arm/disarm skip the native C++ registry even where it is
# available: the C++ monitor always kills the process on expiry (its
# handler is not pluggable from Python), so a claimed recovery handler
# needs the Python-fallback monitor to be the one watching
_force_fallback = False


def force_python_fallback(enable: bool) -> None:
    """Route watchdog arm/disarm through the Python-fallback registry
    even where the native C++ monitor is built: the native monitor cannot
    hand expiries to a Python handler (``set_on_timeout``), which elastic
    recovery (the next slice) claims them through; also useful in
    tests."""
    global _force_fallback
    _force_fallback = bool(enable)
    # the dispatch point memoizes its plan per configuration stamp
    from ..utils import config

    config.bump_config_epoch()


def native_active() -> bool:
    """Whether arm/disarm currently use the native C++ registry."""
    from .. import native

    return native.watchdog_supported() and not _force_fallback


def set_on_timeout(handler: Optional[Callable]) -> None:
    """Replace the expiry handler of the LIVE Python-fallback monitor at
    runtime (``None`` restores the default dump-and-die handler).

    ``handler(entries, expired)`` receives the full in-flight snapshot
    plus the expired entry, after the expiry was journalled as a
    telemetry incident.  A handler that returns (instead of killing the
    process) keeps the monitor alive: the expired entries are drained and
    monitoring continues.  Only the Python-fallback monitor is
    pluggable; the native C++ monitor always dies loudly (its registry is
    not visible from Python), so a recovering handler needs
    ``force_python_fallback(True)``.
    """
    _registry.on_timeout = handler or _default_on_timeout


def drain_registry() -> int:
    """Drop every in-flight entry of both registries, the Python one and
    the native one (test isolation, epoch revocation); returns the count
    dropped."""
    from .. import native

    return _registry.drain() + native.watchdog_drain()


# ---------------------------------------------------------------------------
# arm/disarm around one op
# ---------------------------------------------------------------------------


def arm(mpi_name: str, call_id: str, comm, rank: int, timeout: float) -> None:
    """Arm the watchdog for one op, before its exchange."""
    from .. import native
    from ..telemetry import core as _tcore

    _tcore.meter("watchdog.arms")
    axes = repr(comm.axes)
    if native_active():
        native.watchdog_arm(mpi_name, call_id, rank, axes, timeout)
    else:
        _registry.arm(mpi_name, call_id, int(rank), axes, timeout)


def disarm(call_id: str, rank: int) -> None:
    """Disarm after the op returned (or raised)."""
    from .. import native

    if native_active():
        native.watchdog_disarm(call_id, rank)
    else:
        _registry.disarm(call_id, int(rank))
