"""Runtime health plane: flight ring, straggler detector, postmortems.

PyTorch counterpart of ``mpi4jax_tpu/telemetry/health.py``, on with
``MPI4JAX_TPU_HEALTH=on``:

- **flight ring**: a bounded overwrite ring of the most recent op
  records, fed only from the commit points telemetry already runs: each
  counted dispatch (``core.close_op``, and every record of a pin's stash
  at each CUDA-graph replay, ``core.count_eager_call``) and each events
  journal begin and record (``journal.py``).  So it is fed under
  ``counters`` and ``events`` and never under ``off``, and arming it
  gives no per-op host hook: a pin keeps its graph under ``counters``.
  ``flight_snapshot()`` returns the window; bundles embed it.
- **straggler detector**: rolling latency digests per op key, fed from
  ``core.record_latency`` (events-tier journal ends), checked at
  megastep or commit boundaries (``on_boundary``; ``ensure_boundary_hook``
  registers it in ``parallel/megastep.py``'s boundary registry).  Every
  ``MPI4JAX_TPU_HEALTH_INTERVAL``-th boundary runs the local
  window-against-baseline slowdown check and, given a comm of several
  ranks, one exchange of digest summaries (``_gather_json``: a
  MAX-``allreduce`` of the encoded lengths, then an ``allgather`` of
  uint8 rows, through the port's own ops on the comm's device) for the
  cross-rank skew check (``judge_exchange``, pure: every rank computes
  the same verdicts from the same gathered payloads).  The exchange is a
  collective: every rank must call ``on_boundary`` at the same
  boundaries, and the interval gates them all alike.  Findings journal
  ``health`` incidents and bump ``health.*`` meters.
- **postmortem bundles**: ``dump_postmortem()`` and the automatic
  triggers (a Python-registry watchdog expiry, an injected ``die`` or
  ``hang``) write ``postmortem-p<rank>.json`` under
  ``MPI4JAX_TPU_TELEMETRY_DIR`` (schema ``mpx-postmortem/1``, the JAX
  package's keys), merged by ``python -m mpi4jax_tpu_torch.telemetry
  postmortem <dir>``.  The port runs one process per rank, so each rank
  writes its own bundle, and a rank that wrote none is absent from the
  merged report (the JAX package's one process holds every rank's ring).
  The C++ watchdog (``csrc/host_hooks.cc``) aborts in C++ and writes no
  bundle, as in the JAX package.
- **Prometheus text**: ``prometheus_text()`` renders counters, meters,
  latency digests, drop counts and the health gauges;
  ``MPI4JAX_TPU_HEALTH_PROM`` also writes it to ``prom-p<rank>.prom`` at
  every detector boundary.

The elastic layer (``resilience/elastic.py``) drives the plane's elastic
half: ``elastic.run`` ticks ``on_boundary`` at every step boundary,
bundles a classified failure (``on_failure_classified``) and journals the
agreed verdict (``on_rank_failed``); under
``MPI4JAX_TPU_HEALTH_SUSPECTS`` a persistent straggler is posted as a
``RankFailure`` (``_post_suspects``) and raised from ``on_boundary``, and
a bundle carries the epoch history (``epochs``) once an epoch advanced.
The serving gauges (``_serving_gauges``) read a live serving engine
(``serving/engine.py``) at each boundary it publishes: the KV slots in
use and their share, the p99 request latency and its headroom under the
objective.  A request's arrival is ``Sequence.request.arrival_s``; the
JAX package's gauge reads ``arrival_s`` off the sequence, which has
none, so its p99 and headroom gauges are never set (ROADMAP Queue 3).  A
bundle has no ``tuning`` (no autotune layer).

With ``MPI4JAX_TPU_HEALTH`` unset or ``off`` every entry point returns
before touching state: the snapshot has no ``dropped`` key, and no
service stamp or cache token moves.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..utils import config
from .hist import Histogram

__all__ = [
    "armed",
    "flight_snapshot",
    "dump_postmortem",
    "prometheus_text",
    "on_boundary",
    "set_gauge",
    "reset",
    "POSTMORTEM_SCHEMA",
    "POSTMORTEM_FILE_PREFIX",
    "PROM_FILE_PREFIX",
]

POSTMORTEM_SCHEMA = "mpx-postmortem/1"
POSTMORTEM_FILE_PREFIX = "postmortem-p"
PROM_FILE_PREFIX = "prom-p"

# the detector's thresholds, the JAX package's (module-level so that tests
# can tighten them without new flags)
SLOW_RATIO = 2.0     # window p50 > ratio * baseline p50 -> degraded
SKEW_RATIO = 2.0     # rank mean > ratio * cross-rank median -> slow rank
MIN_SAMPLES = 3      # digests below this sample count are not judged
STRIKE_LIMIT = 2     # consecutive flagged exchanges -> persistent


def armed() -> bool:
    """Whether the health plane is on (``MPI4JAX_TPU_HEALTH=on``)."""
    return config.health_mode() == "on"


def _meter(name: str, n: int = 1) -> None:
    # core imports this module at its top (the ring feed): this edge stays
    # function-local
    from . import core

    core.meter(name, n)


def _incident(meter_name: str, rank: int, detail: str) -> None:
    try:
        from . import journal

        journal.incident(meter_name, "health", int(rank), detail)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# flight ring
# ---------------------------------------------------------------------------


class _Ring:
    """Fixed-capacity overwrite ring.  A push is one index read, one
    increment and one list store: a racing pair of pushes may overwrite
    each other's slot, which costs a record the ring was about to evict
    anyway."""

    __slots__ = ("capacity", "buf", "total")

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.buf: List[Optional[dict]] = [None] * self.capacity
        self.total = 0

    def push(self, record: dict) -> None:
        i = self.total
        self.total = i + 1
        self.buf[i % self.capacity] = record

    def window(self) -> List[dict]:
        n = min(self.total, self.capacity)
        start = self.total - n
        out = []
        for i in range(start, start + n):
            rec = self.buf[i % self.capacity]
            if rec is not None:
                out.append(rec)
        return out


_ring: Optional[_Ring] = None


def _ring_for() -> Optional[_Ring]:
    global _ring
    if not armed():
        return None
    cap = config.flight_ring_capacity()
    r = _ring
    if r is None or r.capacity != cap:
        r = _Ring(cap)
        _ring = r
    return r


def _dispatch_record(rec) -> dict:
    return {
        "kind": "dispatch", "op": rec.op, "comm_uid": str(rec.comm_uid),
        "algo": rec.algo, "dtype": rec.dtype, "bytes": rec.bytes,
        "t": time.time(),
    }


def record_dispatch(rec) -> None:
    """Spill one counted dispatch record (``core.OpRecord``): the counters
    feed, once per counted call, next to the counter."""
    r = _ring_for()
    if r is None:
        return
    r.push(_dispatch_record(rec))


def record_dispatches(recs) -> None:
    """Spill the records of one CUDA-graph replay (a pin's stash,
    ``core.count_eager_call``): one push per record, as
    ``record_dispatch`` makes them, except that only the last
    ``capacity`` records are built; the earlier ones, which those would
    overwrite in this same call, count in ``total`` (and so in
    ``dropped``).  The ring comes out as the per-record pushes leave it."""
    r = _ring_for()
    if r is None or not recs:
        return
    keep = recs[-r.capacity:] if len(recs) > r.capacity else recs
    r.total += len(recs) - len(keep)
    for rec in keep:
        r.push(_dispatch_record(rec))


def record_begin(call_id: str, rank: int, meta: dict,
                 mono: float, wall: float) -> None:
    """Spill one events-tier begin (an arrival).  A begin is no journal
    record until its end arrives, but the ring holds it: the op a hung
    rank never finished is the one a postmortem needs, and a rank that
    never began a call its peers began is the straggler the
    ``postmortem`` command names."""
    r = _ring_for()
    if r is None:
        return
    r.push(dict(meta, kind="begin", call_id=call_id, rank=int(rank),
                t=wall, mono=mono))


def record_event(record: dict) -> None:
    """Spill one completed journal record (type ``op`` or ``instant``);
    the dict is shared, not copied: the journal never changes a record
    after emitting it."""
    r = _ring_for()
    if r is None:
        return
    r.push(record)


def ring_dropped() -> int:
    r = _ring
    if r is None:
        return 0
    return max(0, r.total - r.capacity)


def flight_snapshot() -> dict:
    """JSON-ready view of the flight ring (oldest first)."""
    r = _ring
    if r is None:
        return {"version": 1, "capacity": 0, "total": 0, "dropped": 0,
                "records": []}
    return {
        "version": 1,
        "capacity": r.capacity,
        "total": r.total,
        "dropped": max(0, r.total - r.capacity),
        "records": r.window(),
    }


# ---------------------------------------------------------------------------
# straggler detector
# ---------------------------------------------------------------------------


class _Detector:
    def __init__(self):
        self.lock = threading.Lock()
        self.window: Dict[str, Histogram] = {}
        self.baseline: Dict[str, Histogram] = {}
        self.boundaries = 0
        self.exchanges = 0
        # consecutive flagged exchanges per (process) rank
        self.strikes: Dict[int, int] = {}

    def reset(self) -> None:
        with self.lock:
            self.window.clear()
            self.baseline.clear()
            self.boundaries = 0
            self.exchanges = 0
            self.strikes.clear()


_detector = _Detector()

_gauges: Dict[str, float] = {}


def set_gauge(name: str, value: float) -> None:
    """Set a health gauge (rendered by :func:`prometheus_text`)."""
    _gauges[name] = float(value)


def feed_latency(key: str, seconds: float) -> None:
    """The detector's feed, called by ``core.record_latency`` for every
    measured op latency (events-tier journal ends, megastep per-step
    estimates)."""
    if not armed():
        return
    det = _detector
    with det.lock:
        h = det.window.get(key)
        if h is None:
            h = det.window[key] = Histogram()
        h.record(seconds)


def _summarize_window() -> dict:
    """Pop the current window into ``{key: summary}`` and fold it into the
    baseline (the long-run reference the slowdown check compares
    against)."""
    det = _detector
    findings = []
    with det.lock:
        summary = {}
        for key, h in det.window.items():
            if not h.count:
                continue
            summary[key] = {
                "count": h.count,
                "mean": h.sum / h.count,
                "p50": h.quantile(0.5),
                "max": h.max,
            }
            base = det.baseline.get(key)
            if (base is not None and base.count >= MIN_SAMPLES
                    and h.count >= MIN_SAMPLES):
                bp50 = base.quantile(0.5)
                wp50 = h.quantile(0.5)
                if bp50 and wp50 and wp50 > SLOW_RATIO * bp50:
                    findings.append({
                        "kind": "degraded", "key": key,
                        "window_p50": wp50, "baseline_p50": bp50,
                        "ratio": wp50 / bp50,
                    })
            det.baseline[key] = (base.merge(h) if base is not None
                                 else h)
        det.window = {}
    return {"summary": summary, "findings": findings}


def _gather_json(comm, payload: dict) -> List[dict]:
    """Every rank's JSON payload, moved through the port's own collectives
    on the comm's device (``report.gather_snapshots``' recipe: a
    MAX-``allreduce`` of the encoded lengths, then an ``allgather`` of
    uint8 rows), deduplicated by process and in process order.  Rank r
    contributes its own row, the JAX package's ``global[r]``."""
    import torch

    from ..ops import MAX, allgather, allreduce
    from ..ops._fusion import materialize_value
    from ..parallel.region import resolve_comm

    comm = resolve_comm(comm)
    if comm.mesh is None:
        return [payload]
    local = json.dumps(payload, sort_keys=True).encode()
    dev = comm.device
    length = torch.tensor([len(local)], dtype=torch.int32, device=dev)
    maxlen_t, _ = allreduce(length, op=MAX, comm=comm)
    maxlen = int(materialize_value(maxlen_t).reshape(-1)[0].item())
    row = torch.zeros(maxlen, dtype=torch.uint8)
    row[:len(local)] = torch.frombuffer(bytearray(local), dtype=torch.uint8)
    gathered, _ = allgather(row.to(dev), comm=comm)
    rows = materialize_value(gathered).cpu()
    out = {}
    for r in rows:
        text = bytes(r.tolist()).rstrip(b"\x00").decode()
        if not text:
            continue
        peer = json.loads(text)
        out.setdefault(int(peer.get("process", 0)), peer)
    return [out[p] for p in sorted(out)]


def judge_exchange(peers: List[dict], my_process: int) -> List[dict]:
    """The cross-rank verdicts of one digest exchange: for every op key
    that at least two processes measured (``MIN_SAMPLES`` each or more),
    a process whose mean exceeds ``SKEW_RATIO`` times the cross-process
    median is a *slow rank*.  Pure: every process computes the same
    verdicts from the same gathered payloads."""
    by_key: Dict[str, Dict[int, dict]] = {}
    for peer in peers:
        proc = int(peer.get("process", 0))
        for key, s in (peer.get("summary") or {}).items():
            if s.get("count", 0) >= MIN_SAMPLES:
                by_key.setdefault(key, {})[proc] = s
    findings = []
    for key in sorted(by_key):
        rows = by_key[key]
        if len(rows) < 2:
            continue
        means = sorted(s["mean"] for s in rows.values())
        median = means[len(means) // 2]
        if median <= 0:
            continue
        for proc in sorted(rows):
            mean = rows[proc]["mean"]
            if mean > SKEW_RATIO * median:
                findings.append({
                    "kind": "slow_rank", "rank": proc, "key": key,
                    "mean": mean, "median": median,
                    "ratio": mean / median,
                })
    return findings


def _exchange(comm, summary: dict) -> List[dict]:
    import torch.distributed as dist

    det = _detector
    # the current world's rank (not the journal's launch rank): a flagged
    # rank is handed to the elastic agreement, which speaks of the world
    # as it is now
    my_process = (dist.get_rank()
                  if dist.is_available() and dist.is_initialized() else 0)
    peers = _gather_json(comm, {"process": my_process, "summary": summary})
    det.exchanges += 1
    _meter("health.exchanges")
    findings = judge_exchange(peers, my_process)
    flagged = {f["rank"] for f in findings}
    for f in findings:
        _incident(
            "health.slow_ranks", f["rank"],
            f"rank {f['rank']} slow on {f['key'].split('|')[0]}: mean "
            f"{f['mean'] * 1e6:.1f}us vs cross-rank median "
            f"{f['median'] * 1e6:.1f}us (x{f['ratio']:.2f})",
        )
    suspect_rf = None
    with det.lock:
        for proc in list(det.strikes):
            if proc not in flagged:
                det.strikes.pop(proc)
        for proc in flagged:
            det.strikes[proc] = det.strikes.get(proc, 0) + 1
        persistent = sorted(p for p, n in det.strikes.items()
                            if n >= STRIKE_LIMIT)
    for proc in persistent:
        detail = (f"rank {proc} persistently slow: flagged in "
                  f"{det.strikes.get(proc, STRIKE_LIMIT)} consecutive "
                  "digest exchanges")
        _incident("health.stragglers", proc, detail)
    if persistent and config.health_suspects_enabled():
        suspect_rf = _post_suspects(persistent)
    for f in findings:
        f["persistent"] = f["rank"] in persistent
    if suspect_rf is not None:
        raise suspect_rf
    return findings


def _post_suspects(ranks: List[int]):
    """Hand persistent stragglers to the elastic agreement (opt-in): post
    them as a pending suspected failure and return the ``RankFailure`` for
    the caller to raise (``None`` without the elastic layer)."""
    try:
        from ..resilience import elastic as _elastic
    except ImportError:
        return None
    rf = _elastic.RankFailure(
        frozenset(int(r) for r in ranks),
        "health detector: persistent straggler(s) "
        + ", ".join(str(r) for r in sorted(ranks)),
    )
    _elastic._post_failure(rf)
    _meter("health.suspects_posted", len(ranks))
    return rf


def on_boundary(step, comm=None, engine=None, **info) -> Optional[list]:
    """The detector's tick at one megastep or commit boundary.

    Every ``MPI4JAX_TPU_HEALTH_INTERVAL``-th boundary runs the local
    slowdown check, the cross-rank digest exchange (given a ``comm`` of
    more than one rank; a collective, so every rank of it must tick at the
    same boundaries), the serving gauges (``engine=``) and the optional
    Prometheus file.  Returns the findings of a due boundary (``None``
    otherwise, or when the plane is off).  Raises a ``RankFailure`` only
    when the suspect hand-off is on and a persistent straggler was
    confirmed.
    """
    if not armed():
        return None
    det = _detector
    with det.lock:
        det.boundaries += 1
        due = det.boundaries % config.health_interval() == 0
    if not due:
        return None
    window = _summarize_window()
    findings = list(window["findings"])
    for f in window["findings"]:
        _incident(
            "health.degradations", _process_index(),
            f"{f['key'].split('|')[0]} degraded on this process: window "
            f"p50 {f['window_p50'] * 1e6:.1f}us vs baseline "
            f"{f['baseline_p50'] * 1e6:.1f}us (x{f['ratio']:.2f})",
        )
    if engine is not None:
        _serving_gauges(engine)
    try:
        if comm is not None and _world_of(comm) > 1:
            findings.extend(_exchange(comm, window["summary"]))
    finally:
        if config.health_prom_enabled():
            _write_prom()
    return findings


def _process_index() -> int:
    try:
        from . import journal

        return journal.process_index()
    except Exception:
        return 0


def _world_of(comm) -> int:
    """The flat rank count along the comm's axes (the JAX package's
    ``Comm.world_size``: on a color split, the parent's, not the
    group's)."""
    try:
        from ..parallel.comm import Comm

        return int(Comm.Get_size(comm))
    except Exception:
        return 1


def _serving_gauges(engine) -> None:
    """SLO-headroom and KV-occupancy gauges from a live serving engine
    (best-effort: every attribute is probed, never required)."""
    try:
        alloc = getattr(engine, "_alloc", None)
        if alloc is not None:
            cap = int(getattr(alloc, "capacity", 0) or 0)
            used = len(getattr(alloc, "_used", ()) or ())
            set_gauge("serving_kv_slots_total", cap)
            set_gauge("serving_kv_slots_in_use", used)
            if cap:
                set_gauge("serving_kv_occupancy", used / cap)
        sched = getattr(engine, "_sched", None)
        cfg = getattr(engine, "cfg", None)
        if sched is not None and cfg is not None:
            lat = sorted(
                s.finish_s - s.request.arrival_s
                for s in (getattr(sched, "finished", None) or ())
                if getattr(s, "finish_s", None) is not None
            )
            if lat:
                from ..serving.metrics import percentile

                p99 = percentile(lat, 0.99)
                set_gauge("serving_p99_ms", p99 * 1e3)
                set_gauge("serving_slo_headroom_ms",
                          float(cfg.slo_p99_ms) - p99 * 1e3)
    except Exception:
        pass


_hook_unregister = None


def ensure_boundary_hook() -> None:
    """Register :func:`on_boundary` in the megastep boundary-hook registry
    (``parallel/megastep.py``; once, and only when armed), so that a loop
    that runs ``run_boundary_hooks`` drives the detector.  A loop that owns
    a comm calls ``on_boundary(step, comm=...)`` itself instead."""
    global _hook_unregister
    if _hook_unregister is not None or not armed():
        return
    from ..parallel import megastep as _megastep

    def _hook(step, **info):
        # a boundary consumer that fails stops its loop by design; an
        # observer must not: everything is swallowed (no comm reaches this
        # hook, so the suspect hand-off never fires here)
        try:
            return on_boundary(step, **info)
        except Exception:
            return None

    _hook_unregister = _megastep.register_boundary_hook("health", _hook)


def unregister_boundary_hook() -> None:
    """Take :func:`on_boundary` out of the boundary registry again (test
    isolation; the next armed dispatch registers it anew)."""
    global _hook_unregister
    if _hook_unregister is not None:
        _hook_unregister()
        _hook_unregister = None


# ---------------------------------------------------------------------------
# stall and failure notices (the watchdog; elastic, once ported)
# ---------------------------------------------------------------------------


def on_watchdog_expiry(expired: dict) -> None:
    """Called by the Python watchdog monitor after its expiry incident and
    before its handler: the stall is a health incident and a postmortem
    trigger, while the ring and the in-flight registry still hold the op
    that never finished."""
    if not armed():
        return
    opname = expired.get("opname", "?")
    call_id = expired.get("call_id", "?")
    _incident(
        "health.stalls", expired.get("rank", 0),
        f"{opname} call {call_id} stalled in flight: exceeded "
        f"{expired.get('timeout', 0):g}s without completing",
    )
    maybe_postmortem(f"watchdog_expired: {opname} call {call_id}")


def on_failure_classified(rf) -> None:
    """For the elastic run loop, once an exception classifies as a rank
    failure and before recovery changes any state: a bundle of the world
    as the failure saw it."""
    if not armed():
        return
    maybe_postmortem(f"rank_failure: {getattr(rf, 'detail', rf)}")


def frontier_hint() -> str:
    """One line of this process's last known frontier (the op longest in
    flight in the watchdog's Python registry), for incident details."""
    try:
        from ..resilience import watchdog as _wd

        inflight = _wd.inflight_snapshot()
    except Exception:
        return ""
    if not inflight:
        return ""
    e = max(inflight, key=lambda x: x.get("elapsed", 0))
    return (f"{e.get('opname', '?')} call {e.get('call_id', '?')} "
            f"in flight {e.get('elapsed', 0):.1f}s")


def on_rank_failed(failed, detail: str = "") -> None:
    """For the elastic recovery path, once the failed set is agreed: one
    ``health`` incident per failed rank (every survivor journals the same
    verdict), and the detector's strikes of those ranks dropped, so that
    a removed rank cannot be raised as a suspect again."""
    if not armed():
        return
    det = _detector
    with det.lock:
        for r in failed:
            det.strikes.pop(int(r), None)
    hint = frontier_hint()
    for r in sorted(failed):
        _incident(
            "health.ranks_failed", int(r),
            f"rank {int(r)} agreed failed: {detail}"
            + (f" [local frontier: {hint}]" if hint else ""),
        )


# ---------------------------------------------------------------------------
# postmortem bundles
# ---------------------------------------------------------------------------


def maybe_postmortem(reason: str) -> Optional[str]:
    """The automatic triggers' bundle write (they run on dying or
    aborting paths): a no-op when the plane is off, and it never
    raises."""
    if not armed():
        return None
    try:
        return dump_postmortem(reason)
    except Exception:
        return None


def dump_postmortem(reason: str = "on_demand") -> Optional[str]:
    """Write this process's postmortem bundle under the telemetry
    directory.

    Returns the path, or ``None`` without a directory
    (``MPI4JAX_TPU_TELEMETRY_DIR`` unset: nowhere durable to write).  A
    later dump overwrites the bundle with fresh state and appends its
    reason, so the last writer documents the whole cascade (a watchdog
    expiry, then a classified failure).  The bundle's ``watchdog_inflight``
    is the Python registry's (the C++ registry is not visible from
    Python), ``compile_cache`` the pin counters (``aot.stats()``).
    """
    d = config.telemetry_dir()
    if not d:
        return None
    from . import core, journal

    os.makedirs(d, exist_ok=True)
    path = os.path.join(
        d, f"{POSTMORTEM_FILE_PREFIX}{journal.process_index()}.json")
    reasons = [reason]
    try:
        with open(path) as f:
            prev = json.load(f)
        if prev.get("schema") == POSTMORTEM_SCHEMA:
            reasons = list(prev.get("reasons", ())) + [reason]
    except (OSError, ValueError):
        pass
    det = _detector
    bundle = {
        "schema": POSTMORTEM_SCHEMA,
        "reason": reason,
        "reasons": reasons,
        "process": journal.process_index(),
        "t": time.time(),
        "snapshot": core.snapshot(include_events=False),
        "flight": flight_snapshot(),
        "dropped": {
            "journal": journal.dropped_records(),
            "flight_ring": ring_dropped(),
        },
        "config": {
            "epoch": config.config_epoch(),
            "env": {
                name: val
                for name, val in zip(config.FLAG_NAMES,
                                     config.env_fingerprint())
                if val is not None
            },
        },
        "health": {
            "boundaries": det.boundaries,
            "exchanges": det.exchanges,
            "strikes": {str(k): v for k, v in det.strikes.items()},
            "gauges": dict(_gauges),
        },
    }
    from ..resilience import watchdog as _wd

    bundle["watchdog_inflight"] = _wd.inflight_snapshot()
    try:
        from ..resilience import elastic as _elastic
    except ImportError:
        pass
    else:
        history = _elastic.epoch_history()
        if history:
            bundle["epochs"] = history
    from ..aot import stats as _aot_stats

    bundle["compile_cache"] = _aot_stats()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(bundle, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _meter("health.postmortems")
    return path


# ---------------------------------------------------------------------------
# Prometheus exposition
# ---------------------------------------------------------------------------


def _esc(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _op_labels(row: dict) -> str:
    return (f'op="{_esc(row["op"])}",comm="{_esc(row["comm_uid"])}",'
            f'algo="{_esc(row["algo"])}",dtype="{_esc(row["dtype"])}"')


def prometheus_text() -> str:
    """Counters, meters, latency digests, drop counts and health gauges in
    the Prometheus exposition format (deterministically ordered; the JAX
    package's text, byte for byte, on the same state)."""
    from . import core, journal

    snap = core.snapshot(include_events=False)
    lines = [
        "# HELP mpx_meter_total infrastructure meters "
        "(mpi4jax_tpu telemetry)",
        "# TYPE mpx_meter_total counter",
    ]
    for name in sorted(snap.get("meters", {})):
        lines.append(f'mpx_meter_total{{name="{_esc(name)}"}} '
                     f'{snap["meters"][name]}')
    ops = snap.get("ops", {})
    lines += ["# HELP mpx_op_calls_total per-op dispatch counts",
              "# TYPE mpx_op_calls_total counter"]
    for key in sorted(ops):
        lines.append(f"mpx_op_calls_total{{{_op_labels(ops[key])}}} "
                     f"{ops[key]['calls']}")
    lines += ["# HELP mpx_op_bytes_total per-op payload bytes",
              "# TYPE mpx_op_bytes_total counter"]
    for key in sorted(ops):
        lines.append(f"mpx_op_bytes_total{{{_op_labels(ops[key])}}} "
                     f"{ops[key]['bytes']}")
    lines += ["# HELP mpx_op_latency_seconds measured op latency digest",
              "# TYPE mpx_op_latency_seconds summary"]
    for key in sorted(ops):
        row = ops[key]
        if "latency" not in row:
            continue
        h = Histogram.from_dict(row["latency"])
        labels = _op_labels(row)
        for q in (0.5, 0.99):
            val = h.quantile(q)
            if val is not None:
                lines.append(
                    f'mpx_op_latency_seconds{{{labels},quantile="{q}"}} '
                    f"{val:.9g}")
        lines.append(f"mpx_op_latency_seconds_count{{{labels}}} {h.count}")
        lines.append(f"mpx_op_latency_seconds_sum{{{labels}}} "
                     f"{h.sum:.9g}")
    lines += ["# HELP mpx_dropped_records_total telemetry records "
              "dropped by bounded buffers",
              "# TYPE mpx_dropped_records_total counter",
              f'mpx_dropped_records_total{{source="journal"}} '
              f"{journal.dropped_records()}",
              f'mpx_dropped_records_total{{source="flight_ring"}} '
              f"{ring_dropped()}"]
    det = _detector
    lines += ["# HELP mpx_health_boundaries_total detector boundary ticks",
              "# TYPE mpx_health_boundaries_total counter",
              f"mpx_health_boundaries_total {det.boundaries}",
              "# HELP mpx_health_exchanges_total cross-rank digest "
              "exchanges",
              "# TYPE mpx_health_exchanges_total counter",
              f"mpx_health_exchanges_total {det.exchanges}"]
    for name in sorted(_gauges):
        metric = f"mpx_{name}"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {_gauges[name]:.9g}")
    return "\n".join(lines) + "\n"


def _write_prom() -> None:
    d = config.telemetry_dir()
    if not d:
        return
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"{PROM_FILE_PREFIX}{_process_index()}.prom")
        with open(path, "w") as f:
            f.write(prometheus_text())
    except Exception:
        pass


def reset() -> None:
    """Forget the ring, the detector's state and the gauges (test
    isolation; ``telemetry.reset()`` calls it)."""
    global _ring
    _ring = None
    _detector.reset()
    _gauges.clear()
