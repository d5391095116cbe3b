"""Telemetry core: the mode, per-op counters and infrastructure meters.

PyTorch counterpart of ``mpi4jax_tpu/telemetry/core.py``.  Every op of
the port goes through one dispatch point (``ops/_base.py:run_body``),
which opens an ``OpRecord`` per call and closes it when the op returns:

- ``counters`` counts calls and payload bytes per (op, comm uid,
  algorithm, dtype) and bumps the meters of the machinery around the ops
  (fusion buckets, watchdog arms, fault injections, numeric-guard trips,
  pins run eagerly);
- ``events`` also journals a begin/end record per call and rank
  (``journal.py``, ``bracket.py``), whose latencies feed the per-op
  histograms.

Counting is per executed call.  The JAX package counts a collective
inside ``spmd``/``jit``/``compile`` once per trace and an eager
global-array call once per call; the port has no trace, so it counts
every call, and on the eager path the two agree.  A pinned program
captured as a CUDA graph runs no Python at a replay: its capture stashes
the records its body opened (``capture_eager`` on an ``EagerCell``), and
each replay counts them (``count_eager_call``), as the JAX package's
eager dispatch counts a cache hit.

Mode is ``MPI4JAX_TPU_TELEMETRY={off,counters,events}`` with a
programmatic override (``set_telemetry_mode``), which bumps the
configuration epoch.  The health plane (``health.py``) rides the commit
points here: every counted record (a call's, and each record of a pin's
stash at every replay) is spilled into its flight ring, every measured
latency fed to its detector, and the first dispatch under an armed plane
registers its boundary hook.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..utils import config
from . import health
from .hist import Histogram

__all__ = [
    "set_telemetry_mode",
    "effective_mode",
    "telemetry_cache_token",
    "meter",
    "snapshot",
    "reset",
]

_UNSET = object()
_mode_override = _UNSET


def set_telemetry_mode(mode: Optional[str]) -> None:
    """Programmatic override of ``MPI4JAX_TPU_TELEMETRY`` (``None``
    returns control to the environment)."""
    global _mode_override
    if mode is None:
        _mode_override = _UNSET
        config.bump_config_epoch()
        return
    if mode not in config.TELEMETRY_MODES:
        raise ValueError(
            f"telemetry mode must be one of {config.TELEMETRY_MODES}, "
            f"got {mode!r}"
        )
    _mode_override = mode
    config.bump_config_epoch()


def effective_mode() -> str:
    if _mode_override is not _UNSET:
        return _mode_override
    return config.telemetry_mode()


def events_on() -> bool:
    return effective_mode() == "events"


def telemetry_cache_token() -> tuple:
    """The tier as a key part: what a pin captured under one tier must not
    be replayed under another (``aot/invalidation.py`` reads the epoch and
    the variable)."""
    return (effective_mode(),)


# ---------------------------------------------------------------------------
# the counter registry
# ---------------------------------------------------------------------------


def op_key(op: str, comm_uid, algo: str, dtype: str) -> str:
    """The per-op counter key (also the JSON snapshot key)."""
    return f"{op}|{comm_uid}|{algo}|{dtype}"


class _Counters:
    """Process-wide counter state.  Locked: meters arrive from the
    watchdog's monitor thread as well as the dispatching thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.ops: Dict[str, dict] = {}
        self.meters: Dict[str, int] = {}
        self.latency: Dict[str, Histogram] = {}

    def count_op(self, key: str, nbytes: int, calls: int = 1) -> None:
        with self.lock:
            row = self.ops.setdefault(
                key, {"calls": 0, "bytes": 0, "intra_bytes": 0,
                      "inter_bytes": 0, "wire_inter_bytes": 0})
            row["calls"] += calls
            row["bytes"] += int(nbytes)
            # one host: every byte is intra-host, as the JAX package counts
            # an op without a link model
            row["intra_bytes"] += int(nbytes)

    def bump(self, name: str, n: int) -> None:
        with self.lock:
            self.meters[name] = self.meters.get(name, 0) + n

    def record_latency(self, key: str, seconds: float) -> None:
        with self.lock:
            h = self.latency.get(key)
            if h is None:
                h = self.latency[key] = Histogram()
            h.record(seconds)

    def reset(self) -> None:
        with self.lock:
            self.ops.clear()
            self.meters.clear()
            self.latency.clear()


_counters = _Counters()


def meter(name: str, n: int = 1) -> None:
    """Bump an infrastructure meter (a no-op when telemetry is off).
    Names are dotted paths (``fusion.allreduce.c0.float32.buckets``,
    ``watchdog.arms``, ``aot.eager_pins``, ...)."""
    if effective_mode() == "off":
        return
    _counters.bump(name, n)


def record_latency(key: str, seconds: float) -> None:
    """Feed one measured op latency into its histogram (the journal calls
    this when an events-tier record completes), and into the health
    detector's window (``health.py``)."""
    _counters.record_latency(key, seconds)
    health.feed_latency(key, seconds)


def count_host_op(key: str, nbytes: int) -> None:
    """Count one host-level phase into the per-op table: a bracket around
    a whole phase of several ops (the pipeline's warmup, steady and
    cooldown, ``parallel/pipeline.py``), not one collective.  A no-op when
    telemetry is off, as ``meter``."""
    if effective_mode() == "off":
        return
    _counters.count_op(key, nbytes)


# ---------------------------------------------------------------------------
# dispatch-point op records
# ---------------------------------------------------------------------------


def dtype_name(dtype) -> str:
    """A torch dtype as the JAX package names it (``float32``, ``bool``)."""
    return str(dtype).replace("torch.", "")


class OpRecord:
    """One dispatch's telemetry view."""

    __slots__ = ("op", "comm_uid", "comm_axes", "bytes", "dtype", "algo")

    def __init__(self, op, comm_uid, comm_axes, nbytes, dtype):
        self.op = op
        self.comm_uid = comm_uid
        self.comm_axes = comm_axes
        self.bytes = nbytes
        self.dtype = dtype
        self.algo = "native"

    def key(self) -> str:
        return op_key(self.op, self.comm_uid, self.algo, self.dtype)


# innermost-wins stack of open dispatches (annotate targets the top)
_open_ops: List[OpRecord] = []

# the active capture: while set, closed records land on it instead of the
# counters (a CUDA-graph capture runs no op, each replay runs them all)
_eager_cell: Optional["capture_eager"] = None


class EagerCell:
    """A pin's stash of the records its capture closed, by call signature;
    each replay counts them, summed per key once (a whole-run capture of
    the split-phase solve stashes thousands of records under a few
    keys)."""

    __slots__ = ("by_sig", "_totals")

    def __init__(self):
        self.by_sig: dict = {}
        self._totals: dict = {}

    def records_for(self, sig) -> List[OpRecord]:
        recs = self.by_sig.get(sig)
        if recs is not None:
            return recs
        return next(reversed(self.by_sig.values())) if self.by_sig else []

    def totals_for(self, sig) -> tuple:
        """``((key, calls, bytes), ...)`` of ``records_for(sig)``."""
        totals = self._totals.get(sig)
        if totals is None:
            acc = {}
            for rec in self.records_for(sig):
                calls, nbytes = acc.get(rec.key(), (0, 0))
                acc[rec.key()] = (calls + 1, nbytes + rec.bytes)
            totals = self._totals[sig] = tuple((k, c, b) for k, (c, b) in acc.items())
        return totals


def call_signature(arrays) -> tuple:
    return tuple((tuple(a.shape), dtype_name(a.dtype)) for a in arrays)


class capture_eager:
    """Context manager: records closed inside land on ``cell`` under
    ``sig`` instead of the counters.  A raising capture leaves the stash
    as it was."""

    def __init__(self, cell: EagerCell, sig: tuple):
        self.cell = cell
        self.sig = sig
        self._pending: List[OpRecord] = []

    def __enter__(self):
        global _eager_cell
        self._saved = _eager_cell
        _eager_cell = self
        return self.cell

    def __exit__(self, exc_type, exc, tb):
        global _eager_cell
        _eager_cell = self._saved
        if self._pending and exc_type is None:
            self.cell.by_sig[self.sig] = self._pending
            self.cell._totals.clear()
        return False


def open_op(opname: str, comm, arrays) -> Optional[OpRecord]:
    """Open a record for one dispatch (``None`` when telemetry is off).
    Its bytes and dtype are the first array's, as the JAX package's."""
    if effective_mode() == "off":
        return None
    health.ensure_boundary_hook()
    a0 = arrays[0] if arrays else None
    nbytes, dtype = 0, ""
    if a0 is not None:
        nbytes = a0.numel() * a0.element_size()
        dtype = dtype_name(a0.dtype)
    rec = OpRecord(opname, comm.uid, tuple(comm.axes), nbytes, dtype)
    _open_ops.append(rec)
    return rec


def annotate(**fields) -> None:
    """Record what only the op body knows: the algorithm it took
    (``algo=``).  A no-op when nothing is open."""
    if not _open_ops:
        return
    rec = _open_ops[-1]
    algo = fields.get("algo")
    if algo is not None:
        rec.algo = algo
        meter(f"algo.{rec.op}.{algo}")


def close_op(rec: Optional[OpRecord]) -> None:
    """Commit a record: count it, or stash it on the active capture."""
    if rec is None:
        return
    if _open_ops and _open_ops[-1] is rec:
        _open_ops.pop()
    if _eager_cell is not None:
        _eager_cell._pending.append(rec)
        return
    _counters.count_op(rec.key(), rec.bytes)
    health.record_dispatch(rec)


def abort_op(rec: Optional[OpRecord]) -> None:
    """Unwind a record whose op raised (nothing is counted)."""
    if rec is not None and _open_ops and _open_ops[-1] is rec:
        _open_ops.pop()


def count_eager_call(cell: EagerCell, sig: tuple) -> None:
    """Count one replay of a pin from its stash, and spill each stashed
    record into the flight ring (``health.record_dispatches``), as the
    JAX package's eager dispatch spills each record it counts."""
    if effective_mode() == "off":
        return
    for key, calls, nbytes in cell.totals_for(sig):
        _counters.count_op(key, nbytes, calls)
    health.record_dispatches(cell.records_for(sig))


def current_open() -> Optional[OpRecord]:
    return _open_ops[-1] if _open_ops else None


# ---------------------------------------------------------------------------
# snapshot / reset
# ---------------------------------------------------------------------------


def _row(key: str) -> dict:
    op, uid, algo, dtype = key.split("|")
    return {"op": op, "comm_uid": uid, "algo": algo, "dtype": dtype,
            "calls": 0, "bytes": 0, "intra_bytes": 0, "inter_bytes": 0,
            "wire_inter_bytes": 0}


def snapshot(include_events: bool = False) -> dict:
    """JSON-ready view of everything collected so far on this process, in
    the JAX package's schema; ``include_events`` embeds the events-tier
    journal records (``report()`` reads their arrival times)."""
    from . import journal

    with _counters.lock:
        ops = {}
        for key, row in _counters.ops.items():
            ops[key] = {**_row(key), **{k: row[k] for k in row}}
        for key, h in _counters.latency.items():
            ops.setdefault(key, _row(key))["latency"] = h.to_dict()
        meters = dict(_counters.meters)
    snap = {
        "version": 1,
        "mode": effective_mode(),
        "process": journal.process_index(),
        "ops": ops,
        "meters": meters,
    }
    from ..aot import diskcache, pinning

    cc = {"aot": pinning.stats(), "disk_cache": diskcache.stats()}
    if (any(cc["aot"].values()) or cc["disk_cache"]["enabled"]
            or any(v for k, v in cc["disk_cache"].items()
                   if isinstance(v, int) and not isinstance(v, bool))):
        snap["compile_cache"] = cc
    # present only when a bounded buffer dropped something, so that a
    # healthy snapshot keeps the shape it had before the health plane
    dropped = {"journal": journal.dropped_records(),
               "flight_ring": health.ring_dropped()}
    if any(dropped.values()):
        snap["dropped"] = dropped
    if include_events:
        snap["events"] = journal.snapshot_events()
    return snap


def reset() -> None:
    """Forget every counter, meter, histogram and journal record, and the
    health plane's ring, detector and gauges."""
    from . import journal

    _counters.reset()
    del _open_ops[:]
    journal.reset()
    health.reset()
