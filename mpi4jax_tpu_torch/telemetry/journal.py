"""Events-tier journal: per-rank begin/end records and per-process JSONL.

PyTorch counterpart of ``mpi4jax_tpu/telemetry/journal.py``, with the same
record schema, so that either package's ``merge`` reads the other's
files.  Each instrumented op contributes one record per rank and call:
``begin`` is stamped when the rank reaches the op (its arrival, what
cross-rank skew is computed from), ``end`` when the op's result is ready,
so ``t_end - t_begin`` is the op's time in flight on this host.  Pairing
is FIFO per ``(call_id, rank)`` (an async span's begin may be followed by
other begins under other ids before its end, and a megastep's encloses
its steps'), and each completed pair gets a ``seq`` per key, so the N-th
execution of a call matches across ranks.

Two clocks per timestamp: ``mono`` (monotonic seconds on the process base
of ``native.host_clock``, the latency clock) and ``wall``
(``time.time()``, the clock the merge lays ranks out on).

With ``MPI4JAX_TPU_TELEMETRY_DIR`` set, every completed record is also
appended as one JSON line to ``events-p{process}.jsonl`` there, the input
of ``python -m mpi4jax_tpu_torch.telemetry merge``.  ``process`` is the
``torch.distributed`` rank (0 outside a world).
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Optional

from . import health

__all__ = ["begin", "end", "instant", "incident", "snapshot_events", "reset",
           "process_index", "JOURNAL_FILE_PREFIX"]

JOURNAL_FILE_PREFIX = "events-p"

# in-memory record cap: a runaway events-mode loop drops its oldest
# records (counted) instead of eating the host's memory; the JSONL file
# keeps everything
MAX_RECORDS = 100_000


def _clocks():
    from .. import native

    return native.host_clock()


# the last index seen in a world, kept while an elastic shrink has no
# process group (between the revoked world and the survivors')
_last_index = [0]


def process_index() -> int:
    """This process's rank in the world it was launched in (0 outside
    one): its ``torch.distributed`` rank, mapped back through every
    elastic shrink's renumbering (``resilience/elastic.py:origin_rank``),
    so that a process keeps one journal and one bundle file for its whole
    life."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        from ..resilience.elastic import origin_rank

        _last_index[0] = origin_rank(dist.get_rank())
    return _last_index[0]


class _Journal:
    def __init__(self):
        self.lock = threading.Lock()
        # (call_id, rank) -> deque of (mono, wall, meta)
        self.pending = {}
        # (call_id, rank) -> completed-pair count (the seq counter)
        self.seqs = {}
        self.records = []
        self.dropped = 0
        self._file = None
        self._file_key = None

    def _writer(self):
        """The JSONL appender of the configured directory (opened lazily,
        reopened when the directory or the process index changes;
        line-buffered)."""
        from ..utils import config

        d = config.telemetry_dir()
        if not d:
            return None
        key = (d, process_index())
        if self._file is not None and self._file_key == key:
            return self._file
        if self._file is not None:
            self._file.close()
            self._file = None
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{JOURNAL_FILE_PREFIX}{key[1]}.jsonl")
        self._file = open(path, "a", buffering=1)
        self._file_key = key
        return self._file

    def _emit(self, record: dict) -> None:
        self.records.append(record)
        if len(self.records) > MAX_RECORDS:
            del self.records[0]
            self.dropped += 1
            from . import core

            core.meter("telemetry.dropped")
        # the flight ring (health.py) takes the record the journal built
        health.record_event(record)
        f = self._writer()
        if f is not None:
            f.write(json.dumps(record, sort_keys=True) + "\n")

    def begin(self, call_id: str, rank: int, meta: dict) -> None:
        mono, wall = _clocks()
        with self.lock:
            self.pending.setdefault((call_id, rank), deque()).append(
                (mono, wall, meta))
        # arrivals reach the ring at once: the begin a rank never pairs
        # with an end is the hung op a postmortem needs
        health.record_begin(call_id, rank, meta, mono, wall)

    def end(self, call_id: str, rank: int, end_meta: dict) -> None:
        mono, wall = _clocks()
        key = (call_id, rank)
        with self.lock:
            dq = self.pending.get(key)
            if not dq:
                return  # unmatched end: its begin was dropped by a reset
            mono0, wall0, meta = dq.popleft()
            if not dq:
                del self.pending[key]
            seq = self.seqs.get(key, 0)
            self.seqs[key] = seq + 1
            record = dict(
                meta,
                type="op",
                call_id=call_id,
                seq=seq,
                rank=rank,
                process=process_index(),
                t_begin=wall0,
                t_end=wall,
                mono_begin=mono0,
                mono_end=mono,
                latency=mono - mono0,
            )
            record.update(end_meta)
            self._emit(record)
        from . import core

        core.record_latency(
            core.op_key(record.get("op", "?"), record.get("comm_uid", "?"),
                        record.get("algo", "native"), record.get("dtype", "")),
            record["latency"])
        # a megastep record also gives a per-step estimate: its latency
        # over its trip count
        unroll = record.get("unroll")
        if unroll and unroll > 1 and record.get("op") == "megastep":
            core.record_latency(
                core.op_key("megastep_step", record.get("comm_uid", "?"),
                            "estimate", ""),
                record["latency"] / unroll)

    def instant(self, name: str, rank: int, meta: dict) -> None:
        mono, wall = _clocks()
        with self.lock:
            self._emit(dict(meta, type="instant", name=name, rank=int(rank),
                            process=process_index(), t=wall, mono=mono))

    def flush(self) -> None:
        with self.lock:
            if self._file is not None:
                self._file.flush()

    def reset(self) -> None:
        with self.lock:
            self.pending.clear()
            self.seqs.clear()
            del self.records[:]
            self.dropped = 0
            if self._file is not None:
                self._file.close()
                self._file = None
                self._file_key = None


_journal = _Journal()


def begin(call_id: str, rank: int, meta: dict) -> None:
    _journal.begin(call_id, rank, meta)


def end(call_id: str, rank: int, end_meta: dict) -> None:
    _journal.end(call_id, rank, end_meta)


def instant(name: str, rank: int, meta: Optional[dict] = None) -> None:
    """Journal a point event (a fault injection, a watchdog expiry, a
    numeric-guard trip) on the ops' timeline; a no-op unless the events
    tier is on."""
    from . import core

    if not core.events_on():
        return
    _journal.instant(name, rank, meta or {})


def incident(meter_name: str, name: str, rank, detail: str = "") -> None:
    """An incident of the machinery around the ops: bump the meter
    (counters tier and up) and journal an instant with the detail (events
    tier), flushed so that it survives the process's imminent death."""
    from . import core

    core.meter(meter_name)
    instant(name, int(rank), {"detail": detail} if detail else {})
    flush()


def snapshot_events() -> list:
    """Copy of the in-memory records (JSON-ready dicts)."""
    with _journal.lock:
        return list(_journal.records)


def dropped_records() -> int:
    with _journal.lock:
        return _journal.dropped


def flush() -> None:
    _journal.flush()


def reset() -> None:
    _journal.reset()
