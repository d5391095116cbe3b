"""Dispatch-point recording and the ``MPI4JAX_TPU_ANALYZE`` mode.

PyTorch counterpart of ``mpi4jax_tpu/analysis/hook.py``.  The JAX package
records while ``jax.make_jaxpr`` re-traces a program; the port re-runs it
abstractly instead: every tensor argument becomes a ``meta`` tensor of
its shape and dtype, and while a :class:`Recorder` is pushed the
dispatch point (``ops/_base.py:run_body``) records one
:class:`~.graph.CollectiveEvent` per op and returns the op's abstract
output (one rank's result shape and dtype, as ``meta`` tensors) without
running its body: nothing touches ``torch.distributed`` and no kernel
launches.  Two front-ends share this machinery:

- ``analyze(fn, *args)`` pushes a recorder and re-runs ``fn``;
- the ambient mode (``MPI4JAX_TPU_ANALYZE={off,warn,error}``,
  ``set_analyze_mode``) verifies a region (``parallel/region.py``) at its
  first call for each key, before it runs (``verify_region``), and an op
  called outside every region at its first call for each static key
  (``verify_eager``); ``warn`` warns on findings, ``error`` raises
  :class:`~.report.AnalysisError`.  A key seen before runs no verifier
  code.

Recording is host-side bookkeeping only: under ``warn`` and ``error`` a
clean program runs the same ops, kernels and exchanges as under ``off``.
``analysis_cache_token()`` folds the mode into a pinned program's key
(``aot/pinning.py``): a pin made under one mode is stale under another.
"""

from __future__ import annotations

import warnings
from collections import deque
from contextlib import contextmanager
from typing import List, Optional

from ..utils import config
from .checkers import run_checkers
from .graph import CollectiveEvent, CollectiveGraph
from .report import Report

_UNSET = object()
_mode_override = _UNSET


def set_analyze_mode(mode: Optional[str]) -> None:
    """Programmatic override of ``MPI4JAX_TPU_ANALYZE`` (``None`` returns
    control to the environment), as the runtime services' ``set_*``
    overrides: it bumps the configuration epoch, so the dispatch point
    re-reads its services and a pin made before it goes stale."""
    global _mode_override
    if mode is None:
        _mode_override = _UNSET
        config.bump_config_epoch()
        return
    if mode not in config.ANALYZE_MODES:
        raise ValueError(
            f"analyze mode must be one of {config.ANALYZE_MODES}, got {mode!r}"
        )
    _mode_override = mode
    config.bump_config_epoch()


def effective_mode() -> str:
    if _mode_override is not _UNSET:
        return _mode_override
    return config.analyze_mode()


def analysis_cache_token() -> tuple:
    """The verifier's part of a pinned program's key: flipping the mode,
    or the cross-rank setting, must verify again.  The ambient cost pass
    folds in only when armed, so keys with it off stay as they were."""
    tok = (effective_mode(), config.analyze_ranks())
    if config.analyze_cost_enabled():
        tok = tok + ("cost", config.cost_model_path())
    return tok


class Recorder:
    """Event sink for one recording scope (an ``analyze`` call, or one
    rank's re-run of an ambient verification)."""

    def __init__(self, mode: str):
        self.mode = mode
        self.events: List[CollectiveEvent] = []
        # live token/buffer carriers: events store id()s, so carriers must
        # stay alive for the recording or a collected carrier's id could be
        # reused
        self.pins: List = []
        # (event-stream position, frozenset of buffer ids, call site) per
        # recorded pinned-call donation (record_donation): the MPX139/
        # MPX140 checkers' join key against per-event buffer ids
        self.donations: List[tuple] = []
        # the abstract run's own point-to-point queues, per (comm uid,
        # tag): a send queues here and its recv pops it (ops/send.py,
        # ops/recv.py); the real queues are never touched
        self.queues: dict = {}

    def queue(self, uid: int, tag: int) -> deque:
        return self.queues.setdefault((uid, tag), deque())

    def graph(self) -> CollectiveGraph:
        meta = config_snapshot()
        if self.donations:
            # present only when nonempty, as in the JAX package
            meta["donations"] = tuple(self.donations)
        return CollectiveGraph(events=self.events, meta=meta)


# above 0 while ``compile`` verifies the program it is about to pin: the
# MPX128 advice to pin a hot loop must not fire there
_pinning = [0]


def config_snapshot() -> dict:
    """The configuration the checkers read, in the JAX package's keys:
    the algorithm knob, the crossovers and the topology spec (MPX109,
    MPX113, MPX137, MPX138 read them), fusion, the epoch, the codec.  A
    cost model file or a tuning layer adds its measured crossovers
    (``costmodel.measured_meta``: ``measured_*``), which the MPX111 and
    MPX113 texts cite."""
    from ..ops._fusion import effective_mode as fusion_mode
    from ..parallel.megastep import tracing_megastep
    from ..resilience.elastic import current_epoch
    from ..serving.buckets import declared_buckets
    from ..telemetry.health import armed as _health_armed

    snap = {
        "collective_algo": config.collective_algo(),
        "ring_crossover_bytes": config.ring_crossover_bytes(),
        "dcn_crossover_bytes": config.dcn_crossover_bytes(),
        "alltoall_crossover_bytes": config.alltoall_crossover_bytes(),
        "topology": config.topology_spec(),
        "fusion": fusion_mode(),
        "fusion_bucket_bytes": config.fusion_bucket_bytes(),
        "epoch": current_epoch(),
        "pinned": bool(_pinning[0]),
        "megastep": tracing_megastep(),
        "compress": config.compress_mode(),
    }
    table = declared_buckets()
    if table is not None:
        snap["serving_buckets"] = tuple(table.buckets)
    if _health_armed():
        snap["flight_ring"] = config.flight_ring_capacity()
    from .costmodel import measured_meta

    snap.update(measured_meta())
    return snap


# recorders of the abstract runs in progress; innermost wins
_recorder_stack: List[Recorder] = []

# (event, recorder) currently between begin and end (annotate targets the
# innermost event)
_open_events: List[tuple] = []


def recording() -> bool:
    """True while an abstract run records: the ops record and skip their
    bodies, the ambient verification is not re-entered."""
    return bool(_recorder_stack)



def push_recorder(rec: Recorder) -> None:
    _recorder_stack.append(rec)
    # the dispatch point reads its services once per stamp
    config.bump_service_epoch()


def pop_recorder() -> Recorder:
    rec = _recorder_stack.pop()
    # drop any events left open by an exception mid-op
    while _open_events and _open_events[-1][1] is rec:
        _open_events.pop()
    config.bump_service_epoch()
    return rec


def current_recorder() -> Optional[Recorder]:
    return _recorder_stack[-1] if _recorder_stack else None


@contextmanager
def branch_recording(main: bool):
    """Around one arm of an abstract ``cond``/``switch``
    (``parallel/control.py``): the first arm (``main``) records into the
    current recorder; any other arm into a recorder of its own, with a
    copy of the point-to-point queues, whose events are dropped."""
    rec = current_recorder()
    if rec is None or main:
        yield
        return
    sub = Recorder(rec.mode)
    sub.queues = {k: deque(v) for k, v in rec.queues.items()}
    push_recorder(sub)
    try:
        yield
    finally:
        pop_recorder()


def arm_context(ctx) -> None:
    """The JAX package's per-region recorder: the port verifies a region
    before it runs (``verify_region``), so a region context carries no
    recorder of its own; kept for the JAX package's name."""
    return None


def _target(ctx) -> Optional[Recorder]:
    if _recorder_stack:
        return _recorder_stack[-1]
    return getattr(ctx, "analysis_recorder", None) if ctx is not None else None


def dtype_name(dtype) -> str:
    """A dtype in the JAX package's spelling (``float32``, ``bool``)."""
    return str(dtype).replace("torch.", "")


def begin_event(opname: str, comm, arrays, token, ana: Optional[dict],
                ctx, eager: bool = False) -> Optional[CollectiveEvent]:
    """Record the dispatch of one op.  Returns None unless a recorder is
    active; otherwise the open event, to be closed with ``end_event``."""
    rec = _target(ctx)
    if rec is None:
        return None
    try:
        size = comm.Get_size()
    except RuntimeError:
        size = None
    try:
        min_size = comm.min_size()
    except RuntimeError:
        min_size = None
    a0 = arrays[0] if arrays else None
    evt = CollectiveEvent(
        index=len(rec.events),
        op=opname,
        comm_uid=comm.uid,
        comm_axes=tuple(comm.axes),
        comm_size=size,
        min_size=min_size,
        split=comm.groups is not None,
        payload_bytes=(a0.numel() * a0.element_size()) if a0 is not None else 0,
        dtype=dtype_name(a0.dtype) if a0 is not None else "",
        shape=tuple(a0.shape) if a0 is not None else (),
        eager=eager,
        epoch=getattr(comm, "epoch", None),
        drained=bool(getattr(comm, "drained", False)),
        groups=world_groups(comm),
    )
    ms = getattr(ctx, "megastep", None) if ctx is not None else None
    if ms is not None:
        evt.loop, evt.unroll = ms[0], getattr(ctx, "megastep_unroll", None)
    live = [a for a in arrays if a is not None]
    if live:
        evt.buffers = tuple(id(a) for a in live)
        rec.pins.extend(live)
    if ana:
        for k, v in ana.items():
            if k in ("queue_depth", "bare_int_routing", "traced_structure",
                     "pipeline"):
                evt.extra[k] = v
            else:
                setattr(evt, k, v)
    # no token edges: the port's tokens order nothing (ops/token.py), so a
    # dropped or forked token is no hazard here and MPX107 stays silent
    rec.events.append(evt)
    _open_events.append((evt, rec))
    return evt


def end_event(evt: CollectiveEvent, out) -> None:
    """Close an open event (the JAX package records the produced token
    edge here; the port's tokens order nothing, ``begin_event``)."""
    assert _open_events and _open_events[-1][0] is evt
    _open_events.pop()


def abort_event(evt: CollectiveEvent) -> None:
    """Unwind an open event whose op raised (the raise itself is the
    diagnostic, tagged at the raise site)."""
    if _open_events and _open_events[-1][0] is evt:
        _open_events.pop()


# donations recorded outside any recording scope under the ambient mode:
# (frozenset of buffer ids, call site), carriers pinned alongside; seeded
# into every later recorder at position 0 and capped, as in the JAX
# package
_AMBIENT_DONATION_CAP = 32
_ambient_donations: List[tuple] = []
_ambient_donation_pins: List = []


def record_donation(arrays, where: str, ctx=None) -> None:
    """Record that a pinned call (``aot/pinning.py``, ``donate_argnums``)
    just handed the storage of ``arrays`` to its program.  With a recorder
    active the donation lands at the current event-stream position; under
    the ambient mode with no recorder it joins the log that pre-seeds the
    next recording.  The MPX139/MPX140 checkers intersect the recorded ids
    with span holds and later consumers."""
    live = [a for a in arrays if a is not None]
    if not live:
        return
    rec = _target(ctx)
    if rec is not None:
        rec.pins.extend(live)
        rec.donations.append(
            (len(rec.events), frozenset(id(a) for a in live), where))
        return
    if effective_mode() != "off" and \
            len(_ambient_donations) < _AMBIENT_DONATION_CAP:
        _ambient_donation_pins.extend(live)
        _ambient_donations.append(
            (frozenset(id(a) for a in live), where))


def seed_donations(rec: Recorder) -> None:
    """Pre-seed a fresh recorder with the ambient donations, at stream
    position 0 (a later collective consuming the donated storage is still
    MPX140; no span was open when they landed)."""
    for ids, where in _ambient_donations:
        rec.donations.append((0, ids, where))


def mark_last_event(key: str, value, ctx=None) -> None:
    """Stamp an ``extra`` annotation on the most recently recorded event.
    No-op when nothing records."""
    rec = _target(ctx)
    if rec is not None and rec.events:
        rec.events[-1].extra[key] = value


def annotate(**fields) -> None:
    """Fill fields of the open event.  No-op when nothing records."""
    if not _open_events:
        return
    evt = _open_events[-1][0]
    for k, v in fields.items():
        if k in ("queue_depth", "bare_int_routing", "traced_structure",
                 "pipeline"):
            evt.extra[k] = v
        else:
            setattr(evt, k, v)


def _tables(comm):
    """The rank of every flat rank of every copy of ``comm`` on its grid:
    its world rank, or during a per-rank run its index in the run's scope
    (the rank space the schedules are built in; ``schedule.scope`` orders
    it over the region comm's axes), the copies outside the scope's part
    of the grid left out."""
    if comm.mesh is None:
        return [tuple(range(comm.world_size()))]
    tables = comm._all_member_tables()
    from .schedule import current_scope

    sc = current_scope()
    grid = comm.mesh
    if sc is None or not set(sc.names) <= set(grid.axes):
        return tables
    here = dict(zip(grid.axes, comm._coords()))

    def index(g):
        at = dict(zip(grid.axes, grid.coords(g)))
        if any(at[a] != here[a] for a in grid.axes if a not in sc.coords):
            return None
        r = 0
        for name, size in zip(sc.names, sc.sizes):
            r = r * size + at[name]
        return r

    mapped = [tuple(index(g) for g in t) for t in tables]
    return [t for t in mapped if None not in t]


def event_pairs(comm, source, dest, what: str):
    """A point-to-point op's routing in world ranks (``_tables``), over
    every group of a color split and every copy of a sub-communicator: the
    rank space the per-rank schedules use (``schedule.build_schedule``).
    On a comm over every grid axis these are the JAX package's pairs; on a
    row or column comm the JAX package records the comm's own ranks
    (Queue 3 of ROADMAP.md)."""
    from ..parallel.rankspec import resolve_routing

    groups = comm.groups or (tuple(range(comm.Get_size())),)
    out = []
    for table in _tables(comm):
        for members in groups:
            out.extend((table[members[s]], table[members[d]])
                       for s, d in resolve_routing(source, dest, len(members),
                                                   what=what))
    return tuple(sorted(out))


def world_groups(comm):
    """``comm``'s member groups in world ranks (``_tables``: every group of
    a split, of every copy of a sub-communicator), recorded only during a
    per-rank run, whose schedule builder reads participants from them."""
    from .schedule import concretizing

    if not concretizing():
        return None
    groups = comm.groups or (tuple(range(comm.world_size())),)
    return tuple(tuple(table[r] for r in g)
                 for table in _tables(comm) for g in groups)


def finish(rec: Recorder, where: str, mode: str) -> Optional[Report]:
    """Run the checkers over ``rec``'s stream and act per ``mode``: the
    report (``None`` when clean)."""
    if not rec.events:
        return None
    graph = rec.graph()
    findings = run_checkers(graph)
    if not findings:
        return None
    report = Report(findings=tuple(findings), events=tuple(rec.events),
                    meta=dict(graph.meta))
    act(where, report, mode)
    return report


def act(where: str, report: Report, mode: str) -> None:
    """Sink ``report``, then raise under ``error`` or warn under ``warn``."""
    sink_report(where, report)
    if mode == "error":
        report.raise_if_findings()
    warnings.warn(
        f"MPI4JAX_TPU_ANALYZE: findings in {where}:\n{report.render()}",
        stacklevel=3,
    )


def finish_context(ctx, where: str) -> None:
    """The JAX package's end-of-region check; the port checks a region
    before it runs (``verify_region``), so this only drains a recorder a
    context carries."""
    rec = getattr(ctx, "analysis_recorder", None)
    if rec is None:
        return
    ctx.analysis_recorder = None
    finish(rec, where, rec.mode)


# ---------------------------------------------------------------------------
# report sink (the CLI's aggregation channel)
# ---------------------------------------------------------------------------

_report_sink: Optional[list] = None


def set_report_sink(sink: Optional[list]) -> None:
    """Install (or clear, with ``None``) the ambient report sink: every
    ambient report is appended to it as ``(where, Report)`` before the
    mode's warn/raise action runs."""
    global _report_sink
    _report_sink = sink


def sink_report(where: str, report) -> None:
    if _report_sink is not None:
        _report_sink.append((where, report))


# ---------------------------------------------------------------------------
# memoization (cleared by clear_caches)
# ---------------------------------------------------------------------------

_analyze_cache: dict = {}
# the keys the ambient mode verified: a region or an eager op whose key is
# here runs no verifier code
_verified: dict = {}


def analyze_cache() -> dict:
    return _analyze_cache


def clear_analysis_caches() -> None:
    _analyze_cache.clear()
    _verified.clear()
    del _ambient_donations[:]
    del _ambient_donation_pins[:]


def reset() -> None:
    """Everything back to its default: the override, the sink and the
    caches (the tests' isolation)."""
    global _mode_override, _report_sink
    if _mode_override is not _UNSET:
        _mode_override = _UNSET
        config.bump_config_epoch()
    _report_sink = None
    clear_analysis_caches()
    del _open_events[:]
    while _recorder_stack:
        pop_recorder()
