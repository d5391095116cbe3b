"""Critical-path timing and the performance critic (MPX131-135, MPX144).

PyTorch counterpart of ``mpi4jax_tpu/analysis/cost.py``.
``analyze(fn, *args, cost=True)`` extends the cross-rank progress
simulation (``analysis/progress.py``) into a timed one: the same
buffered-send semantics, but every retirement advances a per-rank clock
by the cost model's prediction (``analysis/costmodel.py``) plus a
roofline compute term from each rank's lineage record
(``analysis/lineage.py``: the bytes each aten op, op and kernel ``meta``
route writes, the counterpart of the JAX package's jaxpr traffic).  The
timed simulation subclasses the progress simulation's retirement hooks,
so the timing and the deadlock verdict agree about what runs when; a
program that deadlocks gets no cost report.

Out come :class:`CostReport` (``Report.cost``: predicted step time, the
per-op and per-link-class breakdown, the critical path rank by rank, the
megastep and fusion amortization) and the quantified advisories, each
stated in predicted microseconds and bytes: MPX131 overlap opportunity,
MPX132 fusion opportunity, MPX133 algorithm mispick, MPX134 structural
load imbalance, MPX135 serialized point-to-point chain on the critical
path, MPX144 pipeline schedule mispick.  The texts are the JAX
package's.  Pure Python: scripted schedules drive it in the tests.
"""


from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..parallel.topology import link_class, span_hosts
from . import costmodel
from .checkers import ALGO_OPS, ENUM_REDUCTIONS, FUSABLE_OPS
from .costmodel import CostModel, OpCost, collective_cost, p2p_cost
from .matcher import MatchedProgram, inst_key
from .progress import _Simulation
from .report import Finding
from .schedule import SchedOp

# codes this module owns in the checker-coverage sense
COST_CODES = ("MPX131", "MPX132", "MPX133", "MPX134", "MPX135", "MPX144")

# MPX131: fraction of a blocking collective's predicted time the
# adjacent compute must be able to hide before the advisory fires
OVERLAP_HIDE_FRACTION = 0.3
# ops with an async *_start/*_wait split (ops/_async.py)
ASYNC_CAPABLE_OPS = ("allreduce", "reduce_scatter", "alltoall")
# MPX133: predicted delta below this fraction of the best time is noise
MISPICK_MIN_FRACTION = 0.10
# MPX135: minimum transfer hops + distinct ranks of a serialized chain,
# and the minimum share of the critical path it must occupy
CHAIN_MIN_HOPS = 3
CHAIN_MIN_RANKS = 3
CHAIN_MIN_FRACTION = 0.2

resolve_model = costmodel.load_model


# ---------------------------------------------------------------------------
# roofline compute estimate from the per-rank lineage records
# ---------------------------------------------------------------------------


def jaxpr_traffic_bytes(closed) -> int:
    """Roofline memory-traffic estimate of one rank's program: the bytes
    every eqn of its lineage record writes (``params["bytes"]``; reads are
    of the same order); a ``cond`` counts its widest arm.  A megastep body
    counts once, as a loop body does in the JAX package: the abstract run
    records it once, and so does the event stream, so compute and
    communication cover the same window.  Duck-typed, so hand-built
    records drive it in the tests."""
    record = getattr(closed, "jaxpr", closed)
    if record is None:
        return 0
    total = 0
    for eqn in getattr(record, "eqns", ()):
        params = getattr(eqn, "params", None) or {}
        branches = params.get("branches")
        if branches:
            total += max((jaxpr_traffic_bytes(b) for b in branches),
                         default=0)
            continue
        total += int(params.get("bytes", 0))
    return total


def host_map_for(comm):
    """``host_of_rank`` of the analyzed comm's world, or ``None`` (all
    ICI) when no topology is derivable — the flat-fallback convention of
    parallel/topology.py."""
    from ..parallel.topology import derive_world_topology

    topo = derive_world_topology(comm)
    return None if topo is None else topo.host_of_rank


# ---------------------------------------------------------------------------
# per-SchedOp cost
# ---------------------------------------------------------------------------


def _base_op(op: SchedOp) -> str:
    if op.kind in ("start", "wait"):
        return op.op.rsplit("_", 1)[0]
    return op.op


def _op_payload(op: SchedOp) -> int:
    if op.fused is not None and op.fused[1]:
        return int(op.fused[1])  # flat-buffer bytes of a fused op
    return int(op.payload_bytes or 0)


def sched_op_cost(op: SchedOp, world: int,
                  host_of_rank=None,
                  payload: Optional[int] = None) -> OpCost:
    """Model one schedule op: group size from the participants claim,
    host span from the dispatch annotation (or the topology map), the
    algorithm the selector recorded (``native`` HLO where none was)."""
    base = _base_op(op)
    nbytes = _op_payload(op) if payload is None else payload
    if op.kind in ("send", "recv"):
        if op.src is None or op.dst is None or host_of_rank is None:
            return p2p_cost(nbytes, same_host=True)
        return p2p_cost(
            nbytes,
            same_host=link_class(host_of_rank, op.src, op.dst) == "ici")
    members = op.participants
    k = len(members) if members else world
    hosts = op.hosts
    if hosts is None and host_of_rank is not None:
        span = members if members else range(world)
        try:
            hosts = span_hosts(host_of_rank, list(span))
        except IndexError:  # sub-world rank ids beyond the map: flat
            hosts = None
    preserve = (op.reduction is not None
                and op.reduction not in ENUM_REDUCTIONS)
    return collective_cost(base, op.algo, nbytes, k, hosts=hosts,
                           hier=op.hier, preserve=preserve,
                           codec=getattr(op, "codec", None))


# ---------------------------------------------------------------------------
# the timed simulation
# ---------------------------------------------------------------------------


class _Node:
    """One retirement on the timeline; ``pred`` is the node that gated
    it (the critical-path back-pointer)."""

    __slots__ = ("rank", "pos", "op", "t0", "t1", "pred")

    def __init__(self, rank, pos, op, t0, t1, pred):
        self.rank = rank
        self.pos = pos
        self.op = op
        self.t0 = t0
        self.t1 = t1
        self.pred = pred

    def to_json(self) -> dict:
        return {
            "rank": self.rank,
            "pos": self.pos,
            "op": self.op.op,
            "kind": self.op.kind,
            "t0_us": round(self.t0, 3),
            "t1_us": round(self.t1, 3),
        }


class _TimedSimulation(_Simulation):
    """The progress simulation with clocks: identical readiness rules,
    plus per-rank time advanced by the cost model at every retirement.
    Between consecutive ops a rank pays its **compute gap** — the
    roofline compute estimate spread uniformly over the schedule's gaps
    (ops + 1), the simplest placement consistent with not knowing where
    the program's FLOPs sit relative to its collectives."""

    def __init__(self, matched: MatchedProgram, model: CostModel,
                 host_of_rank=None, gaps: Optional[Dict[int, float]] = None):
        super().__init__(matched)
        self.model = model
        self.host_of_rank = host_of_rank
        self.world = len(self.ranks)
        self.gap = {r: (gaps or {}).get(r, 0.0) for r in self.ranks}
        self.clock: Dict[int, float] = {r: 0.0 for r in self.ranks}
        self.last: Dict[int, Optional[_Node]] = {r: None for r in self.ranks}
        self.send_nodes: Dict[Tuple, List[_Node]] = {}
        self.pool_nodes: Dict[Tuple, List[_Node]] = {}
        self.start_nodes: Dict[Tuple, Dict[int, _Node]] = {}
        self.inst_time: Dict[Tuple, float] = {}  # per matched instance
        self.link_totals = {
            lc: {"rounds": 0, "bytes": 0, "time_us": 0.0}
            for lc in costmodel.LINK_CLASSES
        }
        self.per_op: Dict[str, Dict] = {}

    # -- bookkeeping -------------------------------------------------------

    def _arrive(self, r: int) -> float:
        """Rank ``r``'s arrival time at its next op: clock + one compute
        gap."""
        return self.clock[r] + self.gap[r]

    def _account(self, op_label: str, cost: OpCost, time_us: float) -> None:
        for lc in costmodel.LINK_CLASSES:
            term = cost.link(lc)
            tot = self.link_totals[lc]
            tot["rounds"] += term.rounds
            tot["bytes"] += term.nbytes
            tot["time_us"] += self.model.link_time_us(lc, term.rounds,
                                                      term.nbytes)
        agg = self.per_op.setdefault(
            op_label, {"count": 0, "time_us": 0.0, "bytes": 0})
        agg["count"] += 1
        agg["time_us"] += time_us
        agg["bytes"] += cost.ici.nbytes + cost.dcn.nbytes

    def _node(self, r: int, op: SchedOp, t0: float, t1: float,
              pred) -> _Node:
        node = _Node(r, op.pos, op, t0, t1, pred)
        self.last[r] = node
        self.clock[r] = t1
        return node

    def _inst_cost(self, key: Tuple, members) -> Tuple[OpCost, float]:
        """Cost of one matched collective instance: the widest member's
        payload prices it (the straggler defines completion — exactly
        MPX134's claim)."""
        present = self.m.instances.get(key, {})
        ops = [present[q] for q in present] or None
        if ops is None:
            return costmodel.ZERO_COST, 0.0
        widest = max(ops, key=_op_payload)
        cost = sched_op_cost(widest, self.world, self.host_of_rank)
        t = self.model.time_us(cost)
        return cost, t

    # -- retirement hooks (the timing semantics) ---------------------------

    def _retire_send(self, r: int, op: SchedOp) -> None:
        # buffered: the sender does not block; the transfer is priced at
        # the matching receive
        t = self._arrive(r)
        node = self._node(r, op, t, t, self.last[r])
        ch = (op.comm_key, op.src, op.dst, op.tag)
        self.send_nodes.setdefault(ch, []).append(node)
        self.pool_nodes.setdefault(
            (op.comm_key, op.dst, op.tag), []).append(node)

    def _retire_recv(self, r: int, op: SchedOp) -> None:
        t = self._arrive(r)
        snode = None
        pool = self.pool_nodes.get((op.comm_key, op.dst, op.tag))
        if op.src is None:
            if pool:
                snode = pool.pop(0)
        else:
            ch = (op.comm_key, op.src, op.dst, op.tag)
            idx = self.ordinal.get((r, op.pos), 0)
            sends = self.send_nodes.get(ch, ())
            if idx < len(sends):
                snode = sends[idx]
                if pool is not None and snode in pool:
                    # mirror the base simulation's _consume_recv, which
                    # drains the wildcard pool for EVERY recv: a later
                    # wildcard must never adopt an already-consumed send
                    pool.remove(snode)
        ready = t if snode is None else max(t, snode.t1)
        same = (snode is None or self.host_of_rank is None
                or link_class(self.host_of_rank, snode.rank, r) == "ici")
        cost = p2p_cost(_op_payload(op), same_host=same)
        dt = self.model.time_us(cost)
        pred = snode if (snode is not None and snode.t1 > t) else self.last[r]
        self._node(r, op, ready, ready + dt, pred)
        self._account(op.op, cost, dt)

    def _retire_start(self, r: int, op: SchedOp) -> None:
        # nonblocking issue: free at issue; the phases are priced at the
        # paired wait, which is what makes overlap visible to the model
        t = self._arrive(r)
        node = self._node(r, op, t, t, self.last[r])
        self.start_nodes.setdefault(inst_key(op), {})[r] = node

    def _retire_coll(self, key: Tuple, members) -> None:
        entries = {q: self._arrive(q) for q in members}
        anchor = max(entries, key=lambda q: (entries[q], q))
        t0 = entries[anchor]
        cost, dt = self._inst_cost(key, members)
        t1 = t0 + dt
        self.inst_time[key] = dt
        anchor_node = self._node(anchor, self.m.instances[key].get(
            anchor, self.m.instances[key][min(self.m.instances[key])]),
            t0, t1, self.last[anchor])
        for q in members:
            if q == anchor:
                continue
            op_q = self.m.instances.get(key, {}).get(q)
            if op_q is None:
                self.clock[q] = t1
                continue
            self._node(q, op_q, t0, t1, anchor_node)
        self._account(_base_op(anchor_node.op), cost, dt)

    def _retire_wait(self, r: int, op: SchedOp) -> None:
        key = inst_key(op)
        starts = self.start_nodes.get(key, {})
        issue = max((n.t1 for n in starts.values()), default=0.0)
        cost, dt = self._inst_cost(key, self.m.expected.get(key, (r,)))
        done = issue + dt
        t = self._arrive(r)
        if key not in self.inst_time:
            self.inst_time[key] = dt
            # account under the base op name, like _retire_coll: one
            # logical collective type = one per-op breakdown row,
            # whether it dispatched blocking or as a start/wait span
            self._account(_base_op(op), cost, dt)
        if done > t:
            anchor = max(starts, key=lambda q: starts[q].t1) if starts \
                else None
            pred = starts.get(anchor) if anchor is not None else self.last[r]
            self._node(r, op, t, done, pred)
        else:  # fully hidden behind the compute since the start
            self._node(r, op, t, t, self.last[r])

    # -- results -----------------------------------------------------------

    def finished(self) -> bool:
        return all(self.head(r) is None for r in self.ranks)

    def finish_times(self) -> Dict[int, float]:
        """Per-rank predicted finish: the clock plus the trailing
        compute gap (a schedule of N ops has N+1 gaps)."""
        return {r: self.clock[r] + self.gap[r] for r in self.ranks}

    def critical_path(self) -> List[_Node]:
        finish = self.finish_times()
        tail_rank = max(finish, key=lambda r: (finish[r], r))
        node = self.last[tail_rank]
        path: List[_Node] = []
        seen = set()
        while node is not None and id(node) not in seen:
            seen.add(id(node))
            path.append(node)
            node = node.pred
        path.reverse()
        return path


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


@dataclass
class CostReport:
    """``Report.cost``: the prediction and its breakdown.  All times in
    microseconds; ``total_us`` is the headline predicted step time
    (critical path + fixed host dispatch)."""

    total_us: float = 0.0
    path_us: float = 0.0
    dispatch_us: float = 0.0
    compute_us: Dict[int, float] = field(default_factory=dict)
    per_link: Dict[str, Dict] = field(default_factory=dict)
    per_op: Dict[str, Dict] = field(default_factory=dict)
    critical_path: List[Dict] = field(default_factory=list)
    amortization: Dict = field(default_factory=dict)
    params: Dict = field(default_factory=dict)
    source: Optional[str] = None
    ranks: Tuple[int, ...] = ()

    def to_json(self) -> Dict:
        return {
            "total_us": round(self.total_us, 3),
            "path_us": round(self.path_us, 3),
            "dispatch_us": round(self.dispatch_us, 3),
            "compute_us": {str(r): round(v, 3)
                           for r, v in sorted(self.compute_us.items())},
            "per_link": {
                lc: {"rounds": v["rounds"], "bytes": v["bytes"],
                     "time_us": round(v["time_us"], 3)}
                for lc, v in self.per_link.items()
            },
            "per_op": {
                op: {"count": v["count"], "bytes": v["bytes"],
                     "time_us": round(v["time_us"], 3)}
                for op, v in sorted(self.per_op.items())
            },
            "critical_path": self.critical_path,
            "amortization": self.amortization,
            "params": self.params,
            "source": self.source,
            "ranks": list(self.ranks),
        }

    def render(self, max_path: int = 20) -> str:
        src = self.source or costmodel.DEFAULTS_NAME
        lines = [
            f"predicted step time: {self.total_us:.1f} us "
            f"(critical path {self.path_us:.1f} us + dispatch "
            f"{self.dispatch_us:.1f} us; cost model: {src})"
        ]
        for lc in sorted(self.per_link):
            v = self.per_link[lc]
            lines.append(
                f"  {lc}: {v['bytes']} B over {v['rounds']} round(s), "
                f"{v['time_us']:.1f} us"
            )
        for op, v in sorted(self.per_op.items()):
            lines.append(
                f"  {op} x{v['count']}: {v['bytes']} B, "
                f"{v['time_us']:.1f} us"
            )
        if self.compute_us:
            hi = max(self.compute_us.values())
            lines.append(f"  compute (roofline): up to {hi:.1f} us/rank")
        if self.critical_path:
            lines.append("  critical path:")
            shown = self.critical_path[:max_path]
            for n in shown:
                lines.append(
                    f"    rank {n['rank']}: {n['op']} (pos {n['pos']}) "
                    f"{n['t0_us']:.1f} -> {n['t1_us']:.1f} us"
                )
            if len(self.critical_path) > len(shown):
                lines.append(
                    f"    ... {len(self.critical_path) - len(shown)} "
                    "more node(s)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


def run_cost_pass(matched: MatchedProgram, *, model: Optional[CostModel]
                  = None, host_of_rank=None, closed=None,
                  meta: Optional[dict] = None
                  ) -> Tuple[Optional[CostReport], List[Finding]]:
    """Timed simulation + the MPX131-135 critic over a matched program.

    ``closed`` maps rank -> lineage record for the roofline
    compute estimate; missing ranks reuse the first available estimate
    (SPMD programs are near-uniform).  Returns ``(None, [])`` when the
    schedules do not run to completion — a deadlocked program has no
    step time, and the progress checker already owns the diagnosis."""
    if model is None:
        model = CostModel()
    meta = dict(meta or {})
    traffic: Dict[int, int] = {}
    default_traffic = 0
    for r in matched.ranks:
        t = jaxpr_traffic_bytes((closed or {}).get(r))
        if t:
            default_traffic = default_traffic or t
        traffic[r] = t
    compute_us = {
        r: model.compute_us(traffic[r] or default_traffic)
        for r in matched.ranks
    }
    gaps = {
        r: compute_us[r] / (len(matched.schedules[r]) + 1)
        for r in matched.ranks
    }
    sim = _TimedSimulation(matched, model, host_of_rank, gaps)
    sim.run()
    if not sim.finished():
        return None, []
    finish = sim.finish_times()
    path_us = max(finish.values()) if finish else 0.0
    path = sim.critical_path()

    findings: List[Finding] = []
    findings.extend(_check_overlap(sim, matched))
    fusion_savings, fusion_findings = _check_fusion(sim, matched, meta)
    findings.extend(fusion_findings)
    findings.extend(_check_mispick(sim, matched))
    findings.extend(_check_imbalance(sim, matched))
    findings.extend(_check_p2p_chain(sim, path, path_us))
    findings.extend(_check_pipeline_mispick(sim, matched))
    findings.sort(key=lambda f: (f.index if f.index is not None else -1,
                                 f.code))

    dispatch = model.dispatch_us
    report = CostReport(
        total_us=path_us + dispatch,
        path_us=path_us,
        dispatch_us=dispatch,
        compute_us=compute_us,
        per_link=sim.link_totals,
        per_op=sim.per_op,
        critical_path=[n.to_json() for n in path],
        amortization={
            "dispatch_us": dispatch,
            # mpx.compile(fn, ..., unroll=N) keeps N steps device-
            # resident per host dispatch (docs/aot.md): host cost ~1/N
            "megastep_per_step_host_us": {
                str(n): round(dispatch / n, 3) for n in (1, 8, 64)
            },
            "fusion_savings_us": round(fusion_savings, 3),
        },
        params=model.to_json(),
        source=model.source,
        ranks=tuple(matched.ranks),
    )
    return report, findings


# ---------------------------------------------------------------------------
# the critic
# ---------------------------------------------------------------------------


def _model_provenance(model) -> str:
    """Advisory-text provenance of a tuning-layer-sourced model
    (``tuned@<stamp>`` — docs/autotune.md): the MPX131-133 texts then
    cite MEASURED parameters, not the analytic defaults.  Empty for
    defaults and plain cost-model files (whose path already rides
    ``Report.cost``)."""
    stamp = getattr(model, "tuned_stamp", None)
    return f" [model tuned@{stamp}]" if stamp else ""


def _check_overlap(sim: _TimedSimulation,
                   matched: MatchedProgram) -> List[Finding]:
    """MPX131: blocking collectives whose predicted wire time the
    adjacent compute could substantially hide via the async split."""
    agg: Dict[Tuple, Dict] = {}
    for key, present in matched.instances.items():
        anchor = min(present)
        op = present[anchor]
        if op.kind != "coll" or _base_op(op) not in ASYNC_CAPABLE_OPS:
            continue
        t = sim.inst_time.get(key, 0.0)
        if t <= 0:
            continue
        gap = max(sim.gap.get(q, 0.0) for q in present)
        hideable = min(gap, t)
        if hideable < OVERLAP_HIDE_FRACTION * t:
            continue
        slot = agg.setdefault((op.op, op.comm_uid), {
            "count": 0, "hideable": 0.0, "total": 0.0, "op": op})
        slot["count"] += 1
        slot["hideable"] += hideable
        slot["total"] += t
    findings = []
    for (name, comm_uid), v in sorted(agg.items(), key=lambda kv: str(kv[0])):
        op = v["op"]
        pct = 100.0 * v["hideable"] / v["total"]
        findings.append(Finding(
            code="MPX131", op=name, index=op.event_index, rank=op.rank,
            seq=op.seq,
            message=(f"{v['count']} blocking {name} collective(s) on comm "
                     f"{comm_uid} predict {v['total']:.1f} us of wire "
                     f"time while the adjacent compute could hide "
                     f"{v['hideable']:.1f} us (~{pct:.0f}%) of it"
                     + _model_provenance(sim.model)),
            suggestion=(f"split them with {name}_start/{name}_wait and "
                        "issue the independent compute between the two "
                        "(mpx.overlap() pairs automatically) — "
                        "docs/overlap.md"),
        ))
    return findings


def _check_fusion(sim: _TimedSimulation, matched: MatchedProgram,
                  meta: dict) -> Tuple[float, List[Finding]]:
    """MPX132: adjacent fusable collectives, priced — N alpha rounds
    collapse into one flat-buffer collective (upgrades MPX111 with
    predicted savings).  Mirrors MPX111's adjacency rule over the
    anchor rank's schedule."""
    if meta.get("fusion") != "off" or not matched.ranks:
        return 0.0, []
    cap = (meta.get("measured_fusion_bucket_bytes")
           or meta.get("fusion_bucket_bytes") or 0)
    sched = matched.schedules[matched.ranks[0]]
    findings: List[Finding] = []
    total_savings = 0.0
    run: List[SchedOp] = []

    def _key(op: SchedOp):
        return (op.op, op.comm_key, op.reduction, op.root)

    def _fusable(op: SchedOp) -> bool:
        # mirror MPX111's rule exactly, eager exclusion included: an
        # eager op never enters the fusion queue, so advising
        # MPI4JAX_TPU_FUSION=auto for it would be wrong
        return (op.kind == "coll" and op.op in FUSABLE_OPS
                and not op.eager and op.fused is None
                and (op.reduction is None
                     or op.reduction in ENUM_REDUCTIONS)
                and (not cap or _op_payload(op) <= cap))

    def _close(run: List[SchedOp]):
        nonlocal total_savings
        if len(run) < 2:
            return
        first = run[0]
        separate = sum(
            sim.model.time_us(sched_op_cost(op, sim.world,
                                            sim.host_of_rank))
            for op in run
        )
        total = sum(_op_payload(op) for op in run)
        fused = sim.model.time_us(sched_op_cost(first, sim.world,
                                                sim.host_of_rank,
                                                payload=total))
        savings = separate - fused
        if savings <= 0:
            return
        total_savings += savings
        findings.append(Finding(
            code="MPX132", op=first.op, index=first.event_index,
            rank=first.rank, seq=first.seq,
            message=(f"{len(run)} adjacent {first.op} collectives on "
                     f"comm {first.comm_uid} ({total} B total) would "
                     f"coalesce into one flat-buffer collective: the "
                     f"cost model predicts {separate:.1f} us separate "
                     f"vs {fused:.1f} us fused — {savings:.1f} us "
                     "saved per step" + _model_provenance(sim.model)),
            suggestion=("set MPI4JAX_TPU_FUSION=auto (or "
                        "mpx.set_fusion_mode('auto')) and consume "
                        "results after issuing the whole batch — "
                        "docs/overlap.md"),
        ))

    for op in sched:
        if _fusable(op) and run and _key(run[-1]) == _key(op):
            run.append(op)
            continue
        _close(run)
        run = [op] if _fusable(op) else []
    _close(run)
    return total_savings, findings


def _check_mispick(sim: _TimedSimulation,
                   matched: MatchedProgram) -> List[Finding]:
    """MPX133: the model disagrees with resolve_algo's pick by more
    than the mispick threshold."""
    findings: List[Finding] = []
    seen = set()
    for key in sorted(matched.instances, key=str):
        present = matched.instances[key]
        op = present[min(present)]
        base = _base_op(op)
        if op.kind != "coll" or (base not in ALGO_OPS
                                 and base != "alltoall"):
            continue
        if base == "alltoall":
            # the permutation family: flat ("native"/"pairwise" price
            # identically — a fixed permutation) vs the two-level split
            if op.algo not in ("native", "pairwise", "hier"):
                continue
            chosen = "native" if op.algo == "pairwise" else op.algo
        else:
            if op.algo not in ("butterfly", "ring", "hier"):
                continue
            chosen = op.algo
        members = op.participants
        k = len(members) if members else sim.world
        if k < 2:
            continue
        nbytes = _op_payload(op)
        hier = op.hier
        if hier is None and op.hosts and op.hosts > 1 and k % op.hosts == 0:
            hier = (op.hosts, k // op.hosts)
        preserve = (op.reduction is not None
                    and op.reduction not in ENUM_REDUCTIONS)
        best, times = costmodel.best_algo(
            base, nbytes, k, sim.model, hosts=op.hosts, hier=hier,
            preserve=preserve)
        if chosen not in times or best == chosen:
            continue
        delta = times[chosen] - times[best]
        if delta < MISPICK_MIN_FRACTION * max(times[best], 1e-9):
            continue
        dedupe = (base, op.comm_uid, nbytes, chosen, best)
        if dedupe in seen:
            continue
        seen.add(dedupe)
        findings.append(Finding(
            code="MPX133", op=op.op, index=op.event_index, rank=op.rank,
            seq=op.seq,
            message=(f"{base} on comm {op.comm_uid} ({nbytes} B over "
                     f"{k} rank(s)) lowered as '{chosen}' "
                     f"({times[chosen]:.1f} us predicted) but the cost "
                     f"model predicts '{best}' at {times[best]:.1f} us "
                     f"— {delta:.1f} us/step faster"
                     + _model_provenance(sim.model)),
            suggestion=(f"force MPI4JAX_TPU_COLLECTIVE_ALGO={best} for "
                        "an A/B run, or recalibrate the crossover flags "
                        "with benchmarks/micro.py --cost-calibrate"),
        ))
    return findings


def _check_imbalance(sim: _TimedSimulation,
                     matched: MatchedProgram) -> List[Finding]:
    """MPX134: rank-divergent payload bytes on one matched collective —
    the widest rank is a straggler by construction."""
    findings: List[Finding] = []
    for key in sorted(matched.instances, key=str):
        present = matched.instances[key]
        if len(present) < 2:
            continue
        op0 = present[min(present)]
        if op0.kind != "coll":
            continue
        payloads = {q: _op_payload(present[q]) for q in present}
        lo_r = min(payloads, key=lambda q: (payloads[q], q))
        hi_r = max(payloads, key=lambda q: (payloads[q], q))
        if payloads[lo_r] == payloads[hi_r]:
            continue
        t_hi = sim.model.time_us(sched_op_cost(
            present[hi_r], sim.world, sim.host_of_rank))
        t_lo = sim.model.time_us(sched_op_cost(
            present[lo_r], sim.world, sim.host_of_rank))
        delta = max(0.0, t_hi - t_lo)
        findings.append(Finding(
            code="MPX134", op=op0.op, index=op0.event_index, rank=hi_r,
            seq=op0.seq,
            message=(f"collective #{op0.seq} on comm {op0.comm_uid} "
                     f"ships {payloads[lo_r]}..{payloads[hi_r]} B across "
                     f"its member ranks: rank {hi_r} is a straggler by "
                     f"construction — every member waits out a "
                     f"predicted +{delta:.1f} us each step"),
            suggestion=("pad or re-shard the payload so matched members "
                        "carry equal bytes (rank-divergent shapes also "
                        "defeat fusion bucketing, docs/overlap.md)"),
        ))
    return findings


def _check_p2p_chain(sim: _TimedSimulation, path: List[_Node],
                     path_us: float) -> List[Finding]:
    """MPX135: a serialized send/recv ladder occupying the critical
    path — the GPipe shape.  Fires on maximal runs of consecutive p2p
    nodes crossing enough distinct ranks (a lockstep halo exchange stays
    on one or two ranks and never trips this)."""
    findings: List[Finding] = []
    if not path or path_us <= 0:
        return findings
    run: List[_Node] = []

    def _close(run: List[_Node]):
        if not run:
            return
        hops = sum(1 for n in run if n.op.kind == "recv")
        ranks = {n.rank for n in run}
        span = run[-1].t1 - run[0].t0
        if (hops < CHAIN_MIN_HOPS or len(ranks) < CHAIN_MIN_RANKS
                or span < CHAIN_MIN_FRACTION * path_us):
            return
        first = run[0]
        chain = " -> ".join(
            f"rank {n.rank}" for i, n in enumerate(run)
            if n.op.kind == "recv" and (i == 0 or run[i - 1].rank != n.rank)
        ) or f"rank {first.rank}"
        pct = 100.0 * span / path_us
        # the chain is pipeline-shaped: price it as a naive ladder over
        # len(ranks) stages and cite the modeled bubble fraction plus
        # the 1F1B twin the schedule compiler would emit instead
        payload = max(
            (_op_payload(n.op) for n in run if n.op.kind == "recv"),
            default=0)
        s = len(ranks)
        m = max(1, hops // max(1, s - 1))
        c = sim.model.compute_us(2 * payload)
        try:
            ladder_us = costmodel.pipeline_wall_us(
                "ladder", s, m, payload, c, sim.model)
            f1b_us = costmodel.pipeline_wall_us(
                "1f1b", s, m, payload, c, sim.model)
            bubble = costmodel.pipeline_bubble_fraction(
                "ladder", s, m, payload, c, sim.model)
        except ValueError:
            ladder_us = f1b_us = bubble = 0.0
        findings.append(Finding(
            code="MPX135", op=first.op.op, index=first.op.event_index,
            rank=first.rank, seq=first.op.seq,
            message=(f"a serialized point-to-point chain of {hops} "
                     f"transfer(s) across ranks "
                     f"{sorted(ranks)} occupies {span:.1f} us "
                     f"(~{pct:.0f}%) of the predicted critical path "
                     f"({chain}): each hop waits for the previous "
                     "stage's full compute + transfer — modeled as a "
                     f"{s}-stage ladder its bubble fraction is "
                     f"{100.0 * bubble:.0f}%"
                     + _model_provenance(sim.model)),
            suggestion=(f"microbatch the ladder with mpx.pipeline "
                        f"(schedule='auto'): at this shape a 1F1B "
                        f"schedule prices at {f1b_us:.1f} us/round vs "
                        f"{ladder_us:.1f} us serialized, so stage i+1's "
                        "transfer overlaps stage i's compute — see "
                        "examples/pipeline_parallel.py and "
                        "docs/pipeline.md"),
        ))

    for n in path:
        if n.op.kind in ("send", "recv"):
            run.append(n)
        else:
            _close(run)
            run = []
    _close(run)
    return findings


def _check_pipeline_mispick(sim: _TimedSimulation,
                            matched: MatchedProgram) -> List[Finding]:
    """MPX144: a pipeline program (mpx.pipeline) stamped its boundary
    transfers with a ``(schedule, stages, microbatches, virtual,
    payload_bytes)`` tuple (SchedOp.meta["pipeline"], via
    hook.mark_last_event); when the cost model prices an expressible
    alternative schedule measurably better at that point, say so.  The
    candidate set matches the compiler's own ``schedule='auto'`` search
    (``costmodel.best_schedule``): gpipe vs 1f1b for a flat program
    (v == 1); a program already chunked into v >= 2 stage-chunks can
    only express interleaved, so it has no alternative and the advisory
    never fires on it — an alternative that needs restructuring is not
    'expressible'."""
    findings: List[Finding] = []
    seen = set()
    for r in matched.ranks:
        for op in matched.schedules[r]:
            stamp = (op.meta or {}).get("pipeline")
            if not stamp:
                continue
            try:
                schedule = str(stamp[0])
                stages, microbatches, virtual, payload = (
                    int(stamp[1]), int(stamp[2]), int(stamp[3]),
                    int(stamp[4]))
            except (TypeError, ValueError, IndexError, KeyError):
                continue
            key = (schedule, stages, microbatches, virtual, payload)
            if key in seen:
                continue
            seen.add(key)
            # same per-microbatch compute estimate the compiler's auto
            # pick uses: the roofline floor of streaming the boundary
            # activation in and out of each stage
            c = sim.model.compute_us(2 * payload)
            try:
                chosen_us = costmodel.pipeline_wall_us(
                    schedule, stages, microbatches, payload, c,
                    sim.model, virtual=virtual)
                best, times = costmodel.best_schedule(
                    stages, microbatches, payload, c, sim.model,
                    virtual=virtual)
            except ValueError:
                continue
            best_us = times[best]
            if best == schedule or chosen_us <= 0:
                continue
            delta = chosen_us - best_us
            if delta < MISPICK_MIN_FRACTION * best_us:
                continue
            try:
                bub_chosen = costmodel.pipeline_bubble_fraction(
                    schedule, stages, microbatches, payload, c,
                    sim.model, virtual=virtual)
                bub_best = costmodel.pipeline_bubble_fraction(
                    best, stages, microbatches, payload, c, sim.model,
                    virtual=virtual)
            except ValueError:
                bub_chosen = bub_best = 0.0
            findings.append(Finding(
                code="MPX144", op=op.op, index=op.event_index, rank=r,
                seq=op.seq,
                message=(f"pipeline program runs schedule '{schedule}' "
                         f"over {stages} stage(s) x {microbatches} "
                         f"microbatch(es) ({payload} B boundary "
                         f"payload): predicted {chosen_us:.1f} us/round "
                         f"vs {best_us:.1f} us for '{best}' — bubble "
                         f"fraction {100.0 * bub_chosen:.0f}% vs "
                         f"{100.0 * bub_best:.0f}%"
                         + _model_provenance(sim.model)),
                suggestion=(f"pass schedule='auto' (or "
                            f"schedule='{best}') to mpx.pipeline so "
                            "the cost model picks the cheaper phase "
                            "program (docs/pipeline.md)"),
            ))
    return findings
