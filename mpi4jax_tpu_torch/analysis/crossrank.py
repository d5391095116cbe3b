"""Abstract re-runs, the cross-rank pass, and the ambient verification.

PyTorch counterpart of ``mpi4jax_tpu/analysis/crossrank.py``.  The JAX
package re-traces a program once per rank with ``jax.make_jaxpr``; the
port re-runs it abstractly (``abstract_run``): every tensor argument
becomes a ``meta`` tensor of its shape and dtype, a
:class:`~.hook.Recorder` is pushed, and the dispatch point records each
op and returns its abstract output without running its body.  Plain
torch arithmetic between ops propagates shapes only, and the kernels
take their ``meta`` routes (``kernels/``).  Nothing touches
``torch.distributed`` and no kernel launches.  A Python branch on a
tensor's value cannot be taken on a ``meta`` tensor, as a Python branch
on a tracer cannot in JAX: ``abstract_run`` raises
:class:`DataDependentBranch` naming the cause.

``analyze(fn, *args, ranks='all')`` and the ambient mode share the
cross-rank machinery:

1. the target is re-run once **per rank** under a
   :class:`~.schedule.ConcreteScope`: ``comm.Get_rank`` returns that rank
   (a ``RankConcrete``) and ``axis_index``/``members`` its place on the
   grid, so rank-dependent Python branches take their real per-rank
   paths (the port's counterpart of the JAX package's ``lax.cond``
   patch);
2. each stream becomes a :class:`~.schedule.SchedOp` schedule;
3. the global matcher pairs collectives by (comm, seq), point-to-point
   by (src, dst, tag) FIFO, and start/wait by span (``matcher.py``);
4. the progress checker simulates the matched program and reports
   deadlock cycles (``progress.py``).

During a per-rank run send and recv record one-sided (``ops/send.py``,
``ops/recv.py``): a rank's schedule may hold only one side of an
exchange, and pairing is the matcher's job.

The ambient mode (``MPI4JAX_TPU_ANALYZE=warn|error``) verifies a region
at its first call for each key (function, argument shapes and dtypes,
statics, comm shape, configuration stamp), **before** the region runs:
the cross-rank pass when ``MPI4JAX_TPU_ANALYZE_RANKS`` admits the comm's
size, then this rank's own re-run through every checker.  Under
``error`` a program with findings raises :class:`~.report.AnalysisError`
on every rank before any message is sent.  A key verified before runs no
verifier code but its dictionary lookup.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils import config
from ..utils.tree import tree_flatten
from . import hook as _hook
from . import lineage as _lineage
from . import schedule as _schedule
from .checkers import run_checkers
from .matcher import match_schedules
from .progress import check_progress
from .report import Finding, Report, finding_from_exception

# the per-trace p2p FIFO replay (MPX101/102/106/110) is skipped on
# per-rank graphs: a rank's schedule legitimately holds one side of an
# exchange.  The matcher re-reports MPX101/102/106 with whole-program
# context, and the progress simulation replays MPX110.
_PER_RANK_SKIP = ("MPX101", "MPX102", "MPX106", "MPX110")

# the abstract runs made, the ambient verifications and their seconds (a
# verified key adds to none of them)
stats = {"runs": 0, "verifications": 0, "seconds": 0.0}


class DataDependentBranch(RuntimeError):
    """A program branched in Python on a tensor's value during an
    abstract run: its collective structure depends on data, which the
    verifier cannot see (the JAX package's ``ConcretizationTypeError``)."""


def to_meta(tree):
    """``tree`` with every tensor replaced by a ``meta`` tensor of its
    shape, strides and dtype (the port's ``ShapeDtypeStruct``)."""
    leaves, unflatten = tree_flatten(tree)
    return unflatten([
        torch.empty_strided(tuple(x.shape), tuple(x.stride()), dtype=x.dtype,
                            device="meta")
        if isinstance(x, torch.Tensor) else x
        for x in leaves
    ])


def avals(tree) -> tuple:
    """The shapes and dtypes of ``tree``'s tensors, the reprs of its other
    leaves, and its structure: a program's abstract signature."""
    leaves, _ = tree_flatten(tree)
    return tuple(
        (tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor)
        else (type(x).__name__, repr(x))
        for x in leaves
    )


def _meta_error(e: BaseException) -> bool:
    text = str(e)
    return "meta" in text and isinstance(e, (RuntimeError, NotImplementedError))


def abstract_run(target, args, kwargs=None, capture=None):
    """Call ``target(*args, **kwargs)`` on ``meta`` templates under the
    current recorder and scope, recorded by ``capture`` (a
    ``lineage.Capture``, its arguments seeded rank-varying) when given.  A
    Python branch on a tensor's value raises :class:`DataDependentBranch`."""
    stats["runs"] += 1
    margs, mkwargs = to_meta(tuple(args)), to_meta(dict(kwargs or {}))
    try:
        if capture is None:
            return target(*margs, **mkwargs)
        capture.seed_args((margs, mkwargs))
        with _lineage.capturing(capture):
            return target(*margs, **mkwargs)
    except DataDependentBranch:
        raise
    except (RuntimeError, NotImplementedError) as e:
        if getattr(e, "mpx_code", None) is None and _meta_error(e):
            raise DataDependentBranch(
                "the program used a tensor's value on the host during an "
                "abstract run (a Python branch, .item(), .tolist() or a "
                "copy to the CPU of a meta tensor): the collective schedule "
                "would depend on data, which the verifier cannot see. Keep "
                "the collective structure data-independent (branch on "
                "static values or on comm.Get_rank()), or pass the value "
                f"as a static argument. Cause: {type(e).__name__}: {e}"
            ) from e
        raise


class _EventStream(list):
    """A rank's recorded events plus the recording's donation records and
    the lineage record of its run (``lineage.Record``, None when the run
    aborted)."""

    donations: tuple = ()
    lineage = None


def trace_rank_schedules(target, args, kwargs, axis_names: Sequence[str],
                         axis_sizes: Sequence[int], rank_list: Sequence[int]):
    """Re-run ``target(*args, **kwargs)`` abstractly once per rank in
    ``rank_list``.  Returns ``(per_rank_events, fatal_findings)``; a rank
    whose run aborts on an MPX-tagged raise contributes a finding (its
    events so far kept), untagged exceptions propagate."""
    per_rank_events: Dict[int, list] = {}
    fatal: List[Finding] = []
    for r in rank_list:
        rec = _hook.Recorder("collect")
        cap = _lineage.Capture(axis_names)
        _hook.push_recorder(rec)
        record = None
        try:
            with _schedule.scope(axis_names, axis_sizes, r):
                abstract_run(target, args, kwargs, capture=cap)
            record = cap.record
        except Exception as e:
            f = finding_from_exception(e)
            if f is None:
                raise
            fatal.append(replace(f, rank=r))
        finally:
            _hook.pop_recorder()
        events = _EventStream(rec.events)
        events.donations = tuple(rec.donations)
        events.lineage = record
        per_rank_events[r] = events
    return per_rank_events, fatal


def uid_watermark() -> int:
    """The comm-uid counter BEFORE the per-rank re-runs: uids below it
    belong to comms shared across the runs (stable identity); uids above
    it are created by each run, aligned by creation order
    (``schedule.build_schedule``).  Read without consuming a uid: every
    rank must build its comms in the same order."""
    from ..parallel import comm as _comm

    return _comm.next_uid()


def match_rank_schedules(per_rank_events: Dict[int, list], world: int,
                         watermark: Optional[int] = None):
    """Per-rank event streams -> schedules -> the matched whole-program
    view."""
    schedules = {
        r: _schedule.build_schedule(events, rank=r, world=world,
                                    uid_watermark=watermark)
        for r, events in per_rank_events.items()
    }
    return match_schedules(schedules)


def cross_rank_findings(per_rank_events: Dict[int, list], world: int,
                        watermark: Optional[int] = None,
                        matched=None) -> List[Finding]:
    """Schedules -> matcher -> progress, over per-rank event streams."""
    if matched is None:
        matched = match_rank_schedules(per_rank_events, world, watermark)
    findings = list(matched.findings)
    findings.extend(check_progress(matched))
    return findings


def per_rank_graph_findings(per_rank_events: Dict[int, list]) -> List[Finding]:
    """The single-run checkers over each rank's stream (minus the p2p
    FIFO replay, ``_PER_RANK_SKIP``), deduplicated across ranks."""
    findings: List[Finding] = []
    seen = set()
    for r in sorted(per_rank_events):
        meta = _hook.config_snapshot()
        donations = getattr(per_rank_events[r], "donations", ())
        if donations:
            meta["donations"] = donations
        graph = _hook.CollectiveGraph(events=per_rank_events[r], meta=meta)
        for f in run_checkers(graph, skip=_PER_RANK_SKIP):
            key = (f.code, f.op, f.index, f.message)
            if key in seen:
                continue
            seen.add(key)
            findings.append(f)
    return findings


def lineage_findings(record, graph, rank=None) -> List[Finding]:
    """The passes over one run's lineage record: MPX108 (``walker``) and
    MPX141/MPX142 (``dataflow``, approximate seeds armed by ``graph``)."""
    from .hazards import hazard_findings
    from .walker import check_cond_divergence

    if record is None:
        return []
    return check_cond_divergence(record) + hazard_findings(record, graph, rank)


def per_rank_cond_findings(per_rank_events: Dict[int, list]) -> List[Finding]:
    """MPX108 over each rank's lineage record, deduplicated by message."""
    from .walker import check_cond_divergence

    findings, seen = [], set()
    for r in sorted(per_rank_events):
        record = getattr(per_rank_events[r], "lineage", None)
        if record is None:
            continue
        for f in check_cond_divergence(record):
            if f.message not in seen:
                seen.add(f.message)
                findings.append(f)
    return findings


def per_rank_hazard_findings(per_rank_events: Dict[int, list]) -> List[Finding]:
    """The dataflow pass (MPX141/MPX142) over each rank's lineage record,
    deduplicated by message; a deduplicated MPX141 names the would-diverge
    rank pair (the first two ranks that surfaced it, or the sole one and
    its successor), as in the JAX package."""
    from .hazards import hazard_findings

    order: List[tuple] = []
    hit_ranks: Dict[tuple, List[int]] = {}
    base: Dict[tuple, Finding] = {}
    for r in sorted(per_rank_events):
        record = getattr(per_rank_events[r], "lineage", None)
        if record is None:
            continue
        graph = _hook.CollectiveGraph(events=per_rank_events[r],
                                      meta=_hook.config_snapshot())
        for f in hazard_findings(record, graph, rank=r):
            key = (f.code, f.op, f.message)
            if key not in base:
                base[key] = f
                order.append(key)
                hit_ranks[key] = []
            hit_ranks[key].append(r)
    findings: List[Finding] = []
    for key in order:
        f = base[key]
        ranks_hit = hit_ranks[key]
        a = ranks_hit[0]
        b = ranks_hit[1] if len(ranks_hit) > 1 else a + 1
        if f.code == "MPX141":
            f = replace(f, message=(
                f"{f.message} (ranks {a} and {b} would diverge here)"))
        findings.append(f)
    return findings


def resolve_rank_list(ranks, world: int) -> Tuple[int, ...]:
    """Normalize the ``ranks`` argument: ``'all'`` -> every rank, an int
    ``n`` -> ranks ``0..n-1``, any iterable -> its sorted unique ints;
    every entry must exist on the comm."""
    if ranks == "all":
        return tuple(range(world))
    if isinstance(ranks, bool):
        raise ValueError("ranks must be 'all', an int, or an iterable "
                         "of ranks")
    if isinstance(ranks, int):
        if not 0 < ranks <= world:
            raise ValueError(
                f"ranks={ranks} out of range for a {world}-rank comm")
        return tuple(range(ranks))
    out = tuple(sorted({int(r) for r in ranks}))
    if not out:
        raise ValueError("ranks must name at least one rank")
    if out[0] < 0 or out[-1] >= world:
        raise ValueError(
            f"ranks {out} out of range for a {world}-rank comm")
    return out


def comm_shape(c) -> Tuple[List[int], int]:
    """The axis sizes of ``c``'s grid along its axes, and their product."""
    mesh = c.mesh
    if mesh is None:
        raise RuntimeError(
            "analyze(ranks=...) needs a comm bound to a process grid (the "
            "rank set and axis sizes come from it): bind one, e.g. the "
            "virtual grid ProcessGrid(shape, axes, device, rank=0)"
        )
    sizes = [mesh.axis_size(a) for a in c.axes]
    world = 1
    for s in sizes:
        world *= s
    return sizes, world


def cross_rank_report(target, args, kwargs, c, rank_list,
                      where_rank0: Optional[int] = None,
                      cost_model=None) -> Report:
    """The ``ranks=`` pass: per-rank re-runs -> per-rank graph checkers and
    lineage passes -> global matcher -> progress checker -> (with a
    ``cost_model``) the critical-path cost pass (``cost.py``)."""
    axis_sizes, world = comm_shape(c)
    watermark = uid_watermark()
    per_rank, fatal = trace_rank_schedules(target, args, kwargs, c.axes,
                                           axis_sizes, rank_list)
    findings = list(fatal)
    fatal_codes = {f.code for f in fatal}
    findings.extend(f for f in per_rank_graph_findings(per_rank)
                    if f.code not in fatal_codes)
    findings.extend(per_rank_cond_findings(per_rank))
    findings.extend(per_rank_hazard_findings(per_rank))
    cost_report = None
    if not fatal:
        matched = match_rank_schedules(per_rank, world, watermark)
        findings.extend(cross_rank_findings(per_rank, world, matched=matched))
        if cost_model is not None:
            from . import cost as _cost

            cost_report, cost_findings = _cost.run_cost_pass(
                matched, model=cost_model, host_of_rank=_cost.host_map_for(c),
                closed={r: getattr(ev, "lineage", None)
                        for r, ev in per_rank.items()},
                meta=_hook.config_snapshot())
            findings.extend(cost_findings)
    first = where_rank0 if where_rank0 is not None else rank_list[0]
    events = per_rank.get(first, ())
    return Report(findings=tuple(findings), events=tuple(events),
                  meta=dict(_hook.config_snapshot(), ranks=list(rank_list)),
                  cost=cost_report)


def single_report(target, args, kwargs, seed: bool = True,
                  axes=("rank",)) -> Report:
    """One abstract run of this process's own path through every checker;
    an MPX-tagged raise becomes the run's one finding for its code.
    ``seed``: start from the ambient donations (``hook.seed_donations``);
    ``axes``: the comm axes its arguments vary over (the lineage's
    wording)."""
    rec = _hook.Recorder("collect")
    if seed:
        _hook.seed_donations(rec)
    _hook.push_recorder(rec)
    cap = _lineage.Capture(axes)
    fatal = None
    try:
        abstract_run(target, args, kwargs, capture=cap)
    except Exception as e:
        fatal = finding_from_exception(e)
        if fatal is None:
            raise
    finally:
        _hook.pop_recorder()
    graph = rec.graph()
    findings = run_checkers(graph)
    if fatal is not None:
        findings = [f for f in findings if f.code != fatal.code]
        findings.insert(0, fatal)
    else:
        findings.extend(lineage_findings(cap.record, graph))
    return Report(findings=tuple(findings), events=tuple(rec.events),
                  meta=dict(graph.meta))


# ---------------------------------------------------------------------------
# the ambient mode, hooked from parallel/region.py and ops/_base.py
# ---------------------------------------------------------------------------


def _ambient_enabled(world: int) -> bool:
    setting = config.analyze_ranks()
    if setting == "off":
        return False
    if setting == "auto":
        return True
    return world <= setting


def verify_region(f, c, statics, static_vals, unroll: int, dyn, kwargs,
                  run) -> None:
    """Verify the region ``run(*dyn, **kwargs)`` over ``c`` (``f`` its
    function) before it runs, once per key; ``run`` is the region body
    itself.  Under ``error`` a region with findings raises at every call
    (the program must not run); under ``warn`` it warns at its first."""
    mode = _hook.effective_mode()
    if mode == "off" or _hook.recording():
        return
    mesh = c.mesh
    shape = tuple(mesh.shape) if mesh is not None else None
    from ..ops._algos import algo_cache_token

    key = ("region", f, c.uid, shape, tuple(statics), static_vals, unroll,
           avals((dyn, kwargs)), config.config_stamp(), algo_cache_token())
    cost_model = None
    if config.analyze_cost_enabled():
        from . import cost as _cost

        try:
            cost_model = _cost.resolve_model(None)
        except ValueError as e:
            warnings.warn(f"MPI4JAX_TPU_ANALYZE_COST: cost pass skipped "
                          f"(tuning file rejected: {e})", stacklevel=3)
        else:
            # folded in only when the cost pass is armed
            key = key + ("cost", cost_model.stamp())
    try:
        hash(key)
    except TypeError:
        key = None
    reports = _hook._verified.get(key) if key is not None else None
    fresh = reports is None
    if fresh:
        t0 = time.perf_counter()
        stats["verifications"] += 1
        name = getattr(f, "__name__", repr(f))
        reports = []
        world = comm_shape(c)[1] if mesh is not None else 1
        # the cost pass prices a one-rank region too (its one schedule)
        if (world >= 2 or cost_model is not None) and _ambient_enabled(world):
            rep = cross_rank_report(run, dyn, kwargs, c, tuple(range(world)),
                                    cost_model=cost_model)
            reports.append((f"cross-rank pass over spmd region {name}", rep))
        rep = single_report(run, dyn, kwargs, axes=tuple(c.axes))
        reports.append((f"spmd region {name}", rep))
        # a clean report is kept when the cost pass ran: the CLI's --cost
        # breakdown covers clean programs too
        reports = [(w, r) for w, r in reports
                   if not r.ok or r.cost is not None]
        if key is not None:
            _hook._verified[key] = reports
        stats["seconds"] += time.perf_counter() - t0
    for where, report in reports:
        if fresh:
            _hook.sink_report(where, report)
        if report.ok:
            continue
        if mode == "error":
            report.raise_if_findings()
        if fresh:
            warnings.warn(
                f"MPI4JAX_TPU_ANALYZE: findings in {where}:\n"
                f"{report.render()}", stacklevel=4)


def verify_eager(opname: str, comm, arrays, token, ana) -> None:
    """Verify one op called outside every region, before it runs, once
    per static key: its event through every checker (the JAX package's
    one-op eager program)."""
    if _hook.recording():
        return
    mode = _hook.effective_mode()
    statics = tuple(sorted((ana or {}).items()))
    from ..ops._algos import algo_cache_token

    key = ("eager", opname, comm.uid, avals(tuple(arrays)), statics,
           config.config_stamp(), algo_cache_token())
    try:
        hash(key)
    except TypeError:
        key = None
    reports = _hook._verified.get(key) if key is not None else None
    fresh = reports is None
    if fresh:
        t0 = time.perf_counter()
        stats["verifications"] += 1
        rec = _hook.Recorder(mode)
        _hook.seed_donations(rec)
        _hook.push_recorder(rec)
        try:
            evt = _hook.begin_event(opname, comm, arrays, token, ana, None,
                                    eager=True)
            _hook.end_event(evt, ())
        finally:
            _hook.pop_recorder()
        graph = rec.graph()
        findings = run_checkers(graph)
        reports = []
        if findings:
            reports = [(f"eager {opname}",
                        Report(findings=tuple(findings),
                               events=tuple(rec.events),
                               meta=dict(graph.meta)))]
        if key is not None:
            _hook._verified[key] = reports
        stats["seconds"] += time.perf_counter() - t0
    for where, report in reports:
        if fresh:
            _hook.sink_report(where, report)
        if mode == "error":
            report.raise_if_findings()
        if fresh:
            warnings.warn(
                f"MPI4JAX_TPU_ANALYZE: findings in {where}:\n"
                f"{report.render()}", stacklevel=4)
