"""The checker registry: pure functions over a :class:`CollectiveGraph`.

The port's own copy of ``mpi4jax_tpu/analysis/checkers.py``, with its 16
graph checkers over 20 codes.  Each checker declares the ``MPX1xx`` codes
it can emit.  Checkers are pure: graph in, findings out.

Two kinds of rules live in the verifier:

- **aborting rules** (MPX101-106): already errors at their raise sites
  (the ops, the routing checks), tagged with their code via
  ``report.mpx_error`` so ``analyze`` converts the raise into a Finding.
  The graph checkers below re-implement them structurally so hand-built
  graphs get the same verdicts;
- **stream rules** (MPX107, MPX109, MPX110, ...): only expressible over
  the whole op stream.

The multi-host advisories (MPX109, MPX113, MPX137, MPX138) read fields
(``algo``, ``hosts``) that only the JAX package's hierarchical lowering
records; on the port's one-host graphs they stay silent, and hand-built
graphs drive them in the tests.
"""

from __future__ import annotations

from typing import Callable, List

from .graph import CollectiveGraph
from .report import CODES, Finding

# ops whose lowering consults the payload-aware selector (ops/_algos.py);
# scan is deliberately absent — its prefix lowering has no ring form
ALGO_OPS = ("allreduce", "reduce", "bcast", "reduce_scatter")

# the JAX package's selector constant (ops/_algos.py), kept literal: the
# port has no algorithm selector, and the MPX109 checker reads it
RING_MIN_GROUP = 4

# ops the fusion deferral layer accepts (ops/_fusion.py), kept literal so
# the checkers import nothing of the ops
FUSABLE_OPS = ("allreduce", "bcast")

# enum reduction names (ops/_base.Op values, mirrored literally): only
# enum reductions defer — a callable records its __name__ here and can
# never fuse, so advising MPI4JAX_TPU_FUSION=auto for it would be wrong
ENUM_REDUCTIONS = ("sum", "prod", "min", "max", "land", "lor", "lxor",
                   "band", "bor", "bxor")

CHECKERS: List[tuple] = []  # (codes, fn)


def checker(*codes: str) -> Callable:
    for c in codes:
        assert c in CODES, f"unknown MPX code {c}"

    def register(fn):
        CHECKERS.append((codes, fn))
        return fn

    return register


def run_checkers(graph: CollectiveGraph, skip=()) -> List[Finding]:
    """Run the registry over ``graph``.  ``skip`` names codes whose
    checkers must not run (the cross-rank front-end skips the per-trace
    p2p FIFO replay: a single rank's schedule legitimately holds one
    side of an exchange — see analysis/crossrank.py)."""
    findings: List[Finding] = []
    for codes, fn in CHECKERS:
        if skip and any(c in skip for c in codes):
            continue
        findings.extend(fn(graph))
    findings.sort(key=lambda f: (f.index if f.index is not None else -1,
                                 f.code))
    return findings


def registered_codes() -> set:
    return {c for codes, _ in CHECKERS for c in codes}


# ---------------------------------------------------------------------------
# point-to-point matching (MPX101 / MPX102 / MPX106 / MPX110)
# ---------------------------------------------------------------------------


@checker("MPX101", "MPX102", "MPX106", "MPX110")
def check_p2p_matching(graph: CollectiveGraph) -> List[Finding]:
    """Replay FIFO matching per (comm, tag) channel over the event stream."""
    findings: List[Finding] = []
    for (comm_uid, tag), events in sorted(graph.by_channel().items(),
                                          key=lambda kv: str(kv[0])):
        # eager p2p uses deferred pairing (the send never enters dispatch,
        # so the stream sees only the recv) — its matching is validated by
        # the eager queues themselves, not replayed here
        events = [e for e in events if not e.eager]
        pending: List = []  # unmatched send events, FIFO
        for e in events:
            if e.op == "send":
                pending.append(e)
                continue
            # recv
            if not pending:
                findings.append(Finding(
                    code="MPX102", op=e.op, index=e.index,
                    message=(f"recv(tag={tag}) on comm {comm_uid} has no "
                             "matching send queued (matching is FIFO per "
                             "(comm, tag) within one region)"),
                    suggestion=("issue the matching send earlier in the "
                                "same parallel region, or check the comm/"
                                "tag pair"),
                ))
                continue
            if len(pending) >= 2 and "queue_depth" not in e.extra:
                e.extra["queue_depth"] = len(pending)
            s = pending.pop(0)
            if (s.dtype and e.dtype and s.dtype != e.dtype) or (
                    s.shape and e.shape and
                    _nelems(s.shape) != _nelems(e.shape)):
                findings.append(Finding(
                    code="MPX106", op=e.op, index=e.index,
                    message=(f"recv template {e.shape}/{e.dtype} does not "
                             f"match the send at {s.where()} "
                             f"({s.shape}/{s.dtype}): MPI type-signature "
                             "rule (shapes may differ only at equal "
                             "element count)"),
                    suggestion="make both sides agree in dtype and element "
                               "count",
                ))
        for s in pending:
            findings.append(Finding(
                code="MPX101", op=s.op, index=s.index,
                message=(f"send(tag={tag}) on comm {comm_uid} is never "
                         "matched by a recv before the region ends "
                         "(matching is FIFO per (comm, tag); the reference "
                         "would deadlock at MPI_Finalize)"),
                suggestion=("add the matching recv on the same comm and "
                            "tag, or drop the send"),
            ))
    # ambiguity advisories (depth annotated by the live recv, or replayed
    # above for hand-built graphs)
    for e in graph.events:
        depth = e.extra.get("queue_depth", 0)
        if e.op == "recv" and depth >= 2:
            findings.append(Finding(
                code="MPX110", op=e.op, index=e.index,
                message=(f"recv(tag={e.tag}) matched while {depth} sends "
                         "were pending on this (comm, tag); FIFO picked "
                         "the oldest"),
                suggestion=("use distinct tags (or a Clone()d comm) if the "
                            "pending sends are not interchangeable"),
            ))
    return findings


def _nelems(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


# ---------------------------------------------------------------------------
# structural statics (MPX103 / MPX104 / MPX105)
# ---------------------------------------------------------------------------


@checker("MPX103", "MPX104")
def check_static_structure(graph: CollectiveGraph) -> List[Finding]:
    """Events flagged non-static at dispatch (the live raise sites tag the
    same hazards; this covers graphs built without tracing)."""
    findings: List[Finding] = []
    for e in graph.events:
        if e.extra.get("bare_int_routing"):
            findings.append(Finding(
                code="MPX103", op=e.op, index=e.index,
                message=(f"{e.op} routing was a bare int rank; under SPMD "
                         "routing describes all ranks at once"),
                suggestion="use pairs=[(src, dst)], shift(k), or a "
                           "{src: dst} dict",
            ))
        if e.extra.get("traced_structure"):
            findings.append(Finding(
                code="MPX104", op=e.op, index=e.index,
                message=(f"{e.op} structural argument "
                         f"({e.extra['traced_structure']}) was a JAX "
                         "tracer; roots/tags/routing must be static"),
                suggestion="pass a Python int (mark it static through jit "
                           "with static_argnums)",
            ))
    return findings


@checker("MPX105")
def check_root_range(graph: CollectiveGraph) -> List[Finding]:
    findings: List[Finding] = []
    for e in graph.events:
        if e.root is None or e.min_size is None:
            continue
        if not 0 <= e.root < e.min_size:
            kind = "smallest group" if e.split else "comm"
            findings.append(Finding(
                code="MPX105", op=e.op, index=e.index,
                message=(f"{e.op} root {e.root} out of range for the "
                         f"{kind} (size {e.min_size})"),
                suggestion=f"use a root in [0, {e.min_size})",
            ))
    return findings


# ---------------------------------------------------------------------------
# token discipline (MPX107)
# ---------------------------------------------------------------------------


@checker("MPX107")
def check_token_chains(graph: CollectiveGraph) -> List[Finding]:
    """Dropped/forked tokens: op ``e`` produced a token that nothing ever
    consumes, while a LATER op on the same comm threads a token that was
    already in circulation before ``e`` — the classic fork::

        t = create_token()
        a, t1 = allreduce(x, token=t)
        b, t2 = allreduce(y, token=t)   # forked from t; t1 dropped

    The final token of a chain is legitimately unconsumed; it only becomes
    a finding when an older token is used after it.
    """
    findings: List[Finding] = []
    for comm_uid, events in sorted(graph.by_comm().items()):
        chain = [e for e in events
                 if e.token_in is not None or e.token_out is not None]
        consumed = {e.token_in for e in chain if e.token_in is not None}
        first_seen: dict = {}
        for pos, e in enumerate(chain):
            for t in (e.token_in, e.token_out):
                if t is not None and t not in first_seen:
                    first_seen[t] = pos
        for pos, e in enumerate(chain):
            if e.token_out is None or e.token_out in consumed:
                continue
            if e.token_out == e.token_in:  # notoken passthrough
                continue
            stale = next(
                (f for f in chain[pos + 1:]
                 if f.token_in is not None
                 and first_seen.get(f.token_in, len(chain)) <= pos),
                None,
            )
            if stale is not None:
                findings.append(Finding(
                    code="MPX107", op=e.op, index=e.index,
                    message=(f"the token produced by {e.where()} is never "
                             f"consumed, but {stale.where()} on the same "
                             "comm threads an older token — the chain was "
                             "forked and this op's ordering dropped"),
                    suggestion=(f"thread {e.where()}'s output token into "
                               f"{stale.where()} (each op consumes the "
                               "previous op's token)"),
                ))
    return findings


# ---------------------------------------------------------------------------
# fusion opportunity (MPX111) + async pairing (MPX112)
# ---------------------------------------------------------------------------


@checker("MPX111")
def check_unfused_adjacent(graph: CollectiveGraph) -> List[Finding]:
    """Adjacent fusable collectives that would bucket, with fusion off:
    a run of >= 2 consecutive events sharing (op, comm, reduction, root),
    each within the bucket byte cap — exactly what
    ``MPI4JAX_TPU_FUSION=auto`` coalesces into one flat-buffer collective
    (the packing is dtype-segregated, so mixed dtypes still bucket).

    Gated on the config snapshot EXPLICITLY recording ``fusion: off``
    (every real trace does, via ``hook.config_snapshot``): hand-built
    graphs without fusion meta are testing other rules.

    When a cost-model tuning file is loaded
    (``MPI4JAX_TPU_COST_MODEL``), the MEASURED fusion bucket takes the
    place of the static env default — both as the bucketing cap and in
    the advisory text (which then cites the calibration source instead
    of the flag)."""
    if graph.meta.get("fusion") != "off":
        return []
    measured = graph.meta.get("measured_fusion_bucket_bytes")
    cap = measured or graph.meta.get("fusion_bucket_bytes", 0)
    cap_cite = (
        f"the measured {measured} B bucket ({_calibration_cite(graph.meta)})"
        if measured else "the fusion bucket cap"
    )
    findings: List[Finding] = []
    run: List = []

    def _key(e):
        return (e.op, e.comm_uid, e.reduction, e.root)

    def _close(run):
        if len(run) >= 2:
            first = run[0]
            total = sum(e.payload_bytes for e in run)
            findings.append(Finding(
                code="MPX111", op=first.op, index=first.index,
                message=(f"{len(run)} adjacent {first.op} collectives on "
                         f"comm {first.comm_uid} "
                         f"(events {first.index}..{run[-1].index}, "
                         f"{total} B total) each fit {cap_cite} and "
                         "would coalesce into one flat-buffer "
                         "collective, but MPI4JAX_TPU_FUSION is off"),
                suggestion=("set MPI4JAX_TPU_FUSION=auto (or call "
                            "mpx.set_fusion_mode('auto')) and consume "
                            "results after issuing the whole batch — see "
                            "docs/overlap.md"),
            ))

    for e in graph.events:
        fusable = (e.op in FUSABLE_OPS and not e.eager
                   and (e.reduction is None or e.reduction in ENUM_REDUCTIONS)
                   and (not cap or e.payload_bytes <= cap))
        if fusable and run and _key(run[-1]) == _key(e):
            run.append(e)
            continue
        _close(run)
        run = [e] if fusable else []
    _close(run)
    return findings


@checker("MPX112")
def check_start_wait(graph: CollectiveGraph) -> List[Finding]:
    """Async pairing: every ``*_start`` needs exactly one later ``*_wait``
    on the same span handle, and every wait needs a live start.  An
    unwaited start's phases are silently dead-code-eliminated (and leave
    the collective watchdog armed); a wait without a live start is a
    double wait."""
    findings: List[Finding] = []
    open_starts: dict = {}  # span id -> start event
    for e in graph.events:
        if e.span is None:
            continue
        if e.op.endswith("_start"):
            open_starts[e.span] = e
        elif e.op.endswith("_wait"):
            if open_starts.pop(e.span, None) is None:
                findings.append(Finding(
                    code="MPX112", op=e.op, index=e.index,
                    message=(f"{e.where()} has no live matching "
                             f"{e.op.replace('_wait', '_start')} on this "
                             "token chain (wait before start, or a "
                             "second wait on the same handle)"),
                    suggestion=("pair each *_start handle with exactly "
                                "one *_wait, in program order"),
                ))
    for span, e in sorted(open_starts.items()):
        findings.append(Finding(
            code="MPX112", op=e.op, index=e.index,
            message=(f"{e.where()} is never waited: its communication "
                     "phases have no consumer and will be dead-code-"
                     "eliminated (with the watchdog armed at start, the "
                     "missing disarm is fatal at run time)"),
            suggestion=(f"call {e.op.replace('_start', '_wait')} on the "
                        "returned handle (mpx.overlap() pairs "
                        "automatically at region exit)"),
        ))
    return findings


# ---------------------------------------------------------------------------
# revoked-epoch collectives (MPX126)
# ---------------------------------------------------------------------------


@checker("MPX126")
def check_epoch_boundary(graph: CollectiveGraph) -> List[Finding]:
    """A collective issued on a comm whose communication epoch is behind
    the current one (``graph.meta["epoch"]``): the world shrank after the
    comm was built — its mesh binding and group tables still describe the
    pre-failure world, dead ranks included.  Recovery through
    ``mpx.elastic.run`` (or an explicit ``comm.shrink``) produces
    current-epoch comms and never fires this; holding a pre-shrink comm
    across the boundary does."""
    current = graph.meta.get("epoch")
    if not current:  # epoch 0 (or no elastic layer): nothing is revoked
        return []
    findings: List[Finding] = []
    for e in graph.events:
        if e.epoch is None or e.epoch >= current:
            continue
        findings.append(Finding(
            code="MPX126", op=e.op, index=e.index,
            message=(f"{e.op} on comm {e.comm_uid} was issued in epoch "
                     f"{current} but the comm was built in epoch "
                     f"{e.epoch}: the world shrank in between and this "
                     "comm still addresses the revoked (pre-failure) "
                     "rank space"),
            suggestion=("re-enter the training loop through "
                        "mpx.elastic.run (it rebuilds comms on "
                        "recovery), or rebuild by hand with "
                        "comm.shrink(failed, mesh=...) — "
                        "docs/resilience.md 'Elastic recovery'"),
        ))
    return findings


# ---------------------------------------------------------------------------
# drained-comm collectives (MPX127)
# ---------------------------------------------------------------------------


@checker("MPX127")
def check_drained_comm(graph: CollectiveGraph) -> List[Finding]:
    """A collective issued on a comm whose world executed a planned
    drain past its leave boundary (``resilience/elastic.py`` graceful
    drain): the drained ranks left ON PURPOSE — the comm's group tables
    still include them, so the collective would wait on peers that
    committed, said goodbye, and exited.  A comm merely *scheduled* to
    drain (boundary not reached) is clean: collectives remain legal
    through the boundary — that is what makes the drain graceful."""
    findings: List[Finding] = []
    for e in graph.events:
        if not e.drained:
            continue
        findings.append(Finding(
            code="MPX127", op=e.op, index=e.index,
            message=(f"{e.op} on comm {e.comm_uid} was issued after the "
                     "comm's leave boundary: its world executed a "
                     "planned drain and the departed ranks will never "
                     "enter this collective"),
            suggestion=("use the comm mpx.elastic.run hands the step "
                        "function after the drain boundary (it is "
                        "rebuilt without the drained ranks), or rebuild "
                        "by hand with comm.shrink(drained, mesh=...) — "
                        "docs/resilience.md 'Grow and graceful drain'"),
        ))
    return findings


# ---------------------------------------------------------------------------
# AOT pinning advisory (MPX128)
# ---------------------------------------------------------------------------

# repeats of one collective signature inside a single trace before the
# advisory fires: below this, dispatch cost is noise; at or above it the
# trace is almost certainly a Python-level hot loop (fori_loop bodies
# trace ONCE, so they never trip this)
AOT_ADVISORY_MIN_REPEATS = 8


@checker("MPX128")
def check_unpinned_hot_loop(graph: CollectiveGraph) -> List[Finding]:
    """A single trace re-dispatching the same (op, comm, statics) prefix
    ``AOT_ADVISORY_MIN_REPEATS``-or-more times: a Python loop unrolled
    into the program — every iteration pays the full dispatch fast path
    at trace time and grows the program linearly — where ``mpx.compile``
    would pin the whole thing once (docs/aot.md).

    Gated on the config snapshot EXPLICITLY recording ``pinned: False``
    (every real trace does, via ``hook.config_snapshot``; a trace that
    is being pinned right now records True): hand-built graphs without
    pinning meta are testing other rules.  Eager events never count —
    each eager op is its own one-op program, not an unrolled loop.
    Events traced inside a megastep loop body (``e.loop`` set,
    parallel/megastep.py) never count either: the body traces ONCE — the
    advisory's advice (keep the loop on device) is already taken, the
    exact mirror of the ``tracing_pinned()`` exemption.
    """
    if graph.meta.get("pinned") is not False:
        return []
    counts: dict = {}
    for e in graph.events:
        if e.eager or e.loop is not None:
            continue
        # point-to-point loops (one send/recv per neighbor) and async
        # spans are STRUCTURE — same-signature repeats there route to
        # different peers, not a hot loop; only whole-group collectives
        # count
        if e.op in ("send", "recv", "sendrecv") or e.span is not None:
            continue
        sig = (e.op, e.comm_uid, e.reduction, e.root, e.tag, e.dtype,
               e.shape)
        counts.setdefault(sig, []).append(e)
    findings: List[Finding] = []
    for sig, events in counts.items():
        if len(events) < AOT_ADVISORY_MIN_REPEATS:
            continue
        first = events[0]
        findings.append(Finding(
            code="MPX128", op=first.op, index=first.index,
            message=(f"{len(events)} dispatches of the same {first.op} "
                     f"signature on comm {first.comm_uid} in one trace "
                     f"(events {first.index}..{events[-1].index}): a "
                     "Python-level hot loop unrolled into the program"),
            suggestion=("pin the program once with mpx.compile(fn, "
                        "*abstract_args, comm=...) and call the pinned "
                        "executable in the loop — or collapse the loop "
                        "onto the device with unroll=: mpx.compile(fn, "
                        "*abstract_args, comm=..., unroll=N) / "
                        "mpx.spmd(..., unroll=N) keeps N iterations "
                        "device-resident per host dispatch (megastep "
                        "execution, docs/aot.md)"),
        ))
    return findings


# ---------------------------------------------------------------------------
# megastep span-straddle error (MPX130)
# ---------------------------------------------------------------------------


@checker("MPX130")
def check_megastep_span_straddle(graph: CollectiveGraph) -> List[Finding]:
    """An async ``*_start``/``*_wait`` span straddling a megastep loop
    boundary (parallel/megastep.py): the loop body traces ONCE, so a
    start whose wait is not inside the same loop body would — at run
    time — leave iteration N's collective phases un-awaited when
    iteration N+1 begins (its instrumentation span armed with nothing to
    disarm it, its phases dead-code-eliminated out of the carry).  Spans
    must open AND close within one iteration; a span fully inside the
    loop body (start and wait under the same loop id) is legal and
    overlaps per-iteration.
    """
    spans: dict = {}
    for e in graph.events:
        if e.span is not None:
            spans.setdefault(e.span, []).append(e)
    findings: List[Finding] = []
    for span_id, events in sorted(spans.items()):
        loops = {e.loop for e in events}
        if loops == {None}:
            continue  # span entirely outside any megastep: MPX112 domain
        first = events[0]
        starts = [e for e in events if e.op.endswith("_start")]
        waits = [e for e in events if e.op.endswith("_wait")]
        if len(loops) > 1:
            where = ("the start is inside the loop body and the wait "
                     "outside (or in a different loop)"
                     if starts and starts[0].loop is not None
                     else "the wait is inside the loop body but its "
                     "start is not")
            findings.append(Finding(
                code="MPX130", op=first.op, index=first.index,
                message=(f"async span {span_id} ({first.op} on comm "
                         f"{first.comm_uid}) straddles a megastep loop "
                         f"boundary: {where}"),
                suggestion=("keep each *_start/*_wait pair inside one "
                            "loop iteration (overlap is per-iteration "
                            "in a megastep), or drop unroll= for this "
                            "program — docs/aot.md 'Megastep "
                            "execution'"),
            ))
        elif not (starts and waits):
            missing = "*_wait" if starts else "*_start"
            findings.append(Finding(
                code="MPX130", op=first.op, index=first.index,
                message=(f"async span {span_id} ({first.op} on comm "
                         f"{first.comm_uid}) opens inside a megastep "
                         f"loop body with no matching {missing} in the "
                         "same iteration: the span straddles the loop "
                         "boundary by construction"),
                suggestion=("issue the matching start/wait inside the "
                            "same loop iteration, or drop unroll= for "
                            "this program — docs/aot.md 'Megastep "
                            "execution'"),
            ))
    return findings


# ---------------------------------------------------------------------------
# serving bucket advisory (MPX136)
# ---------------------------------------------------------------------------


@checker("MPX136")
def check_unbucketed_batch(graph: CollectiveGraph) -> List[Finding]:
    """A traced collective whose leading (batch) dimension is not in the
    DECLARED serving bucket set (``graph.meta["serving_buckets"]``,
    recorded by ``hook.config_snapshot`` from
    ``mpx.serving.declare_buckets``; the engine scopes a declaration
    around its serving loop): under the serving runtime's
    one-program-per-(bucket, phase) rule, such a shape forces an
    unpinned retrace per request count.  Fires once per distinct
    offending batch size.  Inert — and the snapshot key absent —
    whenever no serving runtime has declared a table, so non-serving
    programs are never flagged (their leading dimensions are not batch
    sizes)."""
    buckets = graph.meta.get("serving_buckets")
    if not buckets:
        return []
    declared = set(buckets)
    findings: List[Finding] = []
    flagged: set = set()
    for e in graph.events:
        if e.eager or not e.shape:
            continue
        batch = e.shape[0]
        if batch in declared or batch in flagged:
            continue
        flagged.add(batch)
        findings.append(Finding(
            code="MPX136", op=e.op, index=e.index,
            message=(f"{e.op} payload has leading (batch) dimension "
                     f"{batch}, which is not in the declared serving "
                     f"bucket set {tuple(sorted(declared))}: each "
                     "distinct request batch shape traces and pins a "
                     "separate program — an unpinned retrace per "
                     "request count"),
            suggestion=("pad the live batch to its covering bucket "
                        "before dispatch (BucketTable.bucket_for / "
                        ".pad — the serving engine does this "
                        "automatically), or declare the shape in "
                        "MPI4JAX_TPU_SERVING_BUCKETS — docs/serving.md"),
        ))
    return findings


# ---------------------------------------------------------------------------
# flight-ring capacity advisory (MPX143)
# ---------------------------------------------------------------------------


@checker("MPX143")
def check_flight_ring_capacity(graph: CollectiveGraph) -> List[Finding]:
    """A megastep loop body dispatching more collectives per iteration
    than the health plane's flight-recorder ring can hold
    (telemetry/health.py): in the events tier every execution spills a
    begin AND an end record, so a ring of ``MPI4JAX_TPU_FLIGHT_RING``
    records holds at most ``capacity // 2`` collectives — fewer than one
    iteration means a postmortem bundle's ring has already overwritten
    the iteration's own history by the time a hang is detected.  Gated
    on ``graph.meta["flight_ring"]`` (recorded by
    ``hook.config_snapshot`` only when ``MPI4JAX_TPU_HEALTH=on``), so
    health-off traces — and hand-built graphs testing other rules — are
    never flagged.  Fires at most once per loop id."""
    capacity = graph.meta.get("flight_ring")
    if not capacity:
        return []
    implied = int(capacity) // 2  # begin + end records per collective
    loops: dict = {}
    for e in graph.events:
        if e.loop is not None:
            loops.setdefault(e.loop, []).append(e)
    findings: List[Finding] = []
    for loop_id, events in sorted(loops.items()):
        if len(events) <= implied:
            continue
        first = events[0]
        findings.append(Finding(
            code="MPX143", op=first.op, index=first.index,
            message=(f"megastep loop {loop_id} dispatches {len(events)} "
                     f"collectives per iteration, but "
                     f"MPI4JAX_TPU_FLIGHT_RING={int(capacity)} holds "
                     f"only ~{implied} (a begin + an end record each): "
                     "the flight recorder overwrites the current "
                     "iteration's own history, so a postmortem cannot "
                     "show where the ranks diverged"),
            suggestion=(f"raise MPI4JAX_TPU_FLIGHT_RING to at least "
                        f"{2 * len(events)} (2 records per collective "
                        "per iteration, plus headroom for incidents) — "
                        "docs/observability.md 'Runtime health'"),
        ))
    return findings


# ---------------------------------------------------------------------------
# topology advisory (MPX113)
# ---------------------------------------------------------------------------


@checker("MPX113")
def check_flat_over_dcn(graph: CollectiveGraph) -> List[Finding]:
    """Flat ring/butterfly on a multi-host comm above the ring crossover:
    the payload is large enough that ``auto`` would have chosen the
    two-level ICI/DCN lowering, but a forced flat algorithm (or an
    explicit crossover move) kept the single-level one — every round of
    which is gated on the slowest DCN hop.

    Events carry ``hosts`` only when a hierarchical plan was derivable
    for their comm (``ops/_hierarchy.annotate_selection``), so comms
    whose host partition is non-uniform — where flat is the only option —
    never fire this.  Requires ``comm_size > hosts`` (with one rank per
    host there is no intra level and hier degenerates to flat).

    When a cost-model tuning file is loaded
    (``MPI4JAX_TPU_COST_MODEL``), the MEASURED ring crossover replaces
    the static env default — as the firing threshold and in the
    advisory text, which then cites the calibration source.
    """
    measured = graph.meta.get("measured_ring_crossover_bytes")
    crossover = measured or graph.meta.get("ring_crossover_bytes")
    if not crossover:
        return []
    cite = (
        f"measured crossover, {_calibration_cite(graph.meta)}"
        if measured else "ring crossover"
    )
    findings: List[Finding] = []
    for e in graph.events:
        if e.op not in ALGO_OPS or e.algo not in ("ring", "butterfly"):
            continue
        if not e.hosts or e.hosts <= 1:
            continue
        if e.comm_size is None or e.comm_size <= e.hosts:
            continue
        if e.payload_bytes < crossover:
            continue
        findings.append(Finding(
            code="MPX113", op=e.op, index=e.index,
            message=(f"{e.op} on comm {e.comm_uid} spans {e.hosts} hosts "
                     f"({e.comm_size} ranks) but ran the flat '{e.algo}' "
                     f"algorithm at {e.payload_bytes} B (>= the "
                     f"{crossover} B {cite}): every round is "
                     "gated on the slowest DCN hop"),
            suggestion=("let algo=auto pick the two-level lowering, or "
                        "force MPI4JAX_TPU_COLLECTIVE_ALGO=hier for an "
                        "A/B run — see docs/topology.md"),
        ))
    return findings


@checker("MPX137")
def check_flat_alltoall_over_dcn(graph: CollectiveGraph) -> List[Finding]:
    """Flat alltoall on a multi-host comm above the alltoall crossover:
    the MPX113 analog for the permutation family.  The payload is large
    enough that ``auto`` would have chosen the two-level ICI/DCN
    lowering (intra-host transpose, inter-host exchange of
    host-aggregated contiguous blocks — 1/r the DCN message count), but
    a forced flat algorithm (or an explicit crossover move) kept the
    single-level exchange, whose every per-rank message crosses DCN
    individually.

    Events carry ``hosts`` only when a hierarchical plan was derivable
    for their comm (``ops/_hierarchy.annotate_selection``), so comms
    whose host partition is non-uniform — where flat is the only
    option — never fire this.  Async ``alltoall_start`` spans count
    like the blocking op (the start phase runs the exchange).

    Like its MPX113 template, a calibrated MEASURED crossover (from a
    loaded tuning/cost-model file) replaces the static value — as the
    firing threshold and in the advisory text, which then cites the
    calibration source."""
    measured = graph.meta.get("measured_alltoall_crossover_bytes")
    crossover = measured or graph.meta.get("alltoall_crossover_bytes")
    if not crossover:
        return []
    cite = (
        f"measured alltoall crossover, {_calibration_cite(graph.meta)}"
        if measured else "alltoall crossover"
    )
    findings: List[Finding] = []
    for e in graph.events:
        if e.op not in ("alltoall", "alltoall_start"):
            continue
        if e.algo not in ("native", "pairwise"):
            continue
        if not e.hosts or e.hosts <= 1:
            continue
        if e.comm_size is None or e.comm_size <= e.hosts:
            continue
        if e.payload_bytes < crossover:
            continue
        r = e.comm_size // e.hosts
        findings.append(Finding(
            code="MPX137", op=e.op, index=e.index,
            message=(f"{e.op} on comm {e.comm_uid} spans {e.hosts} hosts "
                     f"({e.comm_size} ranks) but ran the flat "
                     f"'{e.algo}' exchange at {e.payload_bytes} B (>= "
                     f"the {crossover} B {cite}): every "
                     f"rank addresses every remote rank directly — "
                     f"{r}x the DCN message count of the two-level "
                     "lowering"),
            suggestion=("let algo=auto pick the hierarchical alltoall, "
                        "or force MPI4JAX_TPU_COLLECTIVE_ALGO=hier for "
                        "an A/B run — see docs/moe.md and "
                        "docs/topology.md"),
        ))
    return findings


@checker("MPX138")
def check_uncompressed_dcn(graph: CollectiveGraph) -> List[Finding]:
    """Uncompressed above-crossover DCN traffic: a hierarchical
    collective on a multi-host comm ships a float32 inter-host leg at
    or above the DCN crossover while the wire codec layer
    (``MPI4JAX_TPU_COMPRESS``, docs/compression.md) is off.

    Fires only when the snapshot's compress mode is ``off`` — a trace
    that already opted in but left THIS event exact (non-float32,
    callable reduction, payload bucketed to ``off``) made a deliberate
    choice the advisory must not second-guess.  Gates mirror MPX113:
    ``hosts`` present (a plan was derivable), ``comm_size > hosts``
    (a real intra level), and the modeled DCN-leg bytes — payload/r for
    the reduction family, the full payload for alltoall — at or above
    the (measured, when calibrated) DCN crossover.
    """
    if graph.meta.get("compress", "off") != "off":
        return []
    measured = graph.meta.get("measured_dcn_crossover_bytes")
    crossover = measured or graph.meta.get("dcn_crossover_bytes")
    if not crossover:
        return []
    cite = (
        f"measured DCN crossover, {_calibration_cite(graph.meta)}"
        if measured else "DCN crossover"
    )
    compressible = ("allreduce", "reduce_scatter", "alltoall",
                    "allreduce_start", "reduce_scatter_start",
                    "alltoall_start")
    findings: List[Finding] = []
    for e in graph.events:
        if e.op not in compressible or e.algo != "hier":
            continue
        if getattr(e, "codec", None) is not None:
            continue
        if not e.hosts or e.hosts <= 1:
            continue
        if e.comm_size is None or e.comm_size <= e.hosts:
            continue
        if e.dtype not in ("", "float32"):
            continue  # the codec layer only compresses float32
        r = e.comm_size // e.hosts
        leg = (e.payload_bytes if e.op.startswith("alltoall")
               else -(-e.payload_bytes // max(r, 1)))
        if leg < crossover:
            continue
        findings.append(Finding(
            code="MPX138", op=e.op, index=e.index,
            message=(f"{e.op} on comm {e.comm_uid} spans {e.hosts} hosts "
                     f"({e.comm_size} ranks) and ships a {leg} B "
                     f"float32 DCN leg uncompressed (>= the {crossover} "
                     f"B {cite}): MPI4JAX_TPU_COMPRESS=bf16 would halve "
                     "the wire bytes on that leg (fp8 would quarter "
                     "them), ICI staying exact"),
            suggestion=("opt in with MPI4JAX_TPU_COMPRESS=bf16 (not "
                        "bit-identical — pair gradients with "
                        "mpx.compress.ef_allreduce), or let "
                        "mpx.autotune() sweep the codecs against the "
                        "error budget — see docs/compression.md"),
        ))
    return findings


# ---------------------------------------------------------------------------
# perf advisory (MPX109)
# ---------------------------------------------------------------------------


def _calibration_cite(meta: dict) -> str:
    """Provenance of a measured threshold in an advisory text: the
    tuning layer's content stamp (``tuned@<stamp>`` — docs/autotune.md)
    when one is active, else the cost-model file path
    (``MPI4JAX_TPU_COST_MODEL``)."""
    stamp = meta.get("tuned_stamp")
    if stamp:
        return f"tuned@{stamp}"
    return f"cost model {meta.get('cost_model')}"


@checker("MPX109")
def check_crossover_proximity(graph: CollectiveGraph) -> List[Finding]:
    """Payload within 2x of the ring/butterfly crossover under algo=auto:
    shape-polymorphic retraces straddling the threshold silently flip the
    lowering (same math, different perf) between traces.  With an active
    tuning layer the crossover in the snapshot IS the measured value
    (the config layer serves it), and the text carries the
    ``tuned@<stamp>`` provenance."""
    if graph.meta.get("collective_algo", "auto") != "auto":
        return []
    crossover = graph.meta.get("ring_crossover_bytes")
    if not crossover:
        return []
    # cite measured provenance only when the effective crossover IS the
    # layer's measured value — a file that tunes other knobs, or an env
    # override shadowing the file, must not be presented as "measured"
    measured = graph.meta.get("measured_ring_crossover_bytes")
    cite = (f"measured ring crossover, {_calibration_cite(graph.meta)}"
            if graph.meta.get("tuned_stamp") and measured == crossover
            else "ring crossover")
    findings: List[Finding] = []
    for e in graph.events:
        if e.op not in ALGO_OPS or e.algo in (None, "native"):
            continue
        k = e.comm_size
        if k is None or k < RING_MIN_GROUP:
            continue
        if crossover / 2 <= e.payload_bytes < crossover * 2:
            findings.append(Finding(
                code="MPX109", op=e.op, index=e.index,
                message=(f"{e.op} payload ({e.payload_bytes} B) is within "
                         f"2x of the {cite} ({crossover} B) under "
                         "algo=auto: retraces at nearby shapes may pick "
                         f"different lowerings (this trace chose "
                         f"'{e.algo}')"),
                suggestion=("pin MPI4JAX_TPU_COLLECTIVE_ALGO=butterfly or "
                            "=ring for this workload, or move "
                            "MPI4JAX_TPU_RING_CROSSOVER_BYTES away from "
                            "the working payload size"),
            ))
    return findings


# the donation hazard checkers (MPX139/MPX140, analysis/hazards.py)
# register themselves on import; imported at the bottom so hazards can
# import ``checker`` from this module without a cycle
from . import hazards  # noqa: E402,F401
