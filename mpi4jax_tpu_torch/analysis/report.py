"""Findings, reports, and the MPX error-code catalog.

The port's own copy of ``mpi4jax_tpu/analysis/report.py``: the whole
catalog, every code with its title, severity and text (those that stay
silent in the port, for want of the algorithm selector and the multi-host
lowerings, included), so that a finding renders and
serializes the same in both packages.  Every rule the JAX package's
``docs/sharp_bits.md`` states in prose carries a stable ``MPX1xx`` code
here, so a diagnostic can be grepped the way a compiler warning is.
Codes are append-only: a released code never changes meaning.

The module imports nothing of the package (the port's ops and the
routing checks raise through ``mpx_error`` without an import cycle) and
nothing of PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


ERROR = "error"
ADVISORY = "advisory"

# where a finding sends the user: the port's own command and twin, in place
# of the JAX package's ``benchmarks/micro.py --cost-calibrate`` and
# ``examples/pipeline_parallel.py`` (the only texts that differ from it)
CALIBRATE_COMMAND = "python -m mpi4jax_tpu_torch.autotune"
PIPELINE_EXAMPLE = "mpi4jax_tpu_torch/models/pipeline_parallel.py"


@dataclass(frozen=True)
class CodeInfo:
    """Catalog entry for one diagnostic code."""

    code: str
    title: str
    severity: str
    doc: str


# The checker catalog: the JAX package's, entry by entry, but for the two
# names above (the port's tests hold the two equal).
CODES = {
    c.code: c
    for c in (
        CodeInfo(
            "MPX101", "unmatched send", ERROR,
            "A send was never matched by a recv on the same (comm, tag) "
            "before its parallel region (or flush/exit, for eager sends) "
            "ended.  Matching is FIFO per (comm, tag); the reference "
            "implementation would deadlock at run time.",
        ),
        CodeInfo(
            "MPX102", "recv without matching send", ERROR,
            "A recv found no queued send on its (comm, tag).  Under SPMD "
            "the matching send must appear earlier in the same region "
            "(FIFO per channel); the reference would block forever.",
        ),
        CodeInfo(
            "MPX103", "bare-int routing", ERROR,
            "A point-to-point routing spec was a bare int rank.  One SPMD "
            "program describes all ranks at once, so 'dest=1' would mean "
            "every rank sends to rank 1 — not a permutation.",
        ),
        CodeInfo(
            "MPX104", "traced structural argument", ERROR,
            "A root, tag, or routing spec was a JAX tracer.  Structure "
            "must be static Python values: one traced program serves all "
            "ranks, so structural choices cannot depend on traced data.",
        ),
        CodeInfo(
            "MPX105", "root out of range", ERROR,
            "A static root index does not exist on the communicator (on a "
            "color split it must be a valid group position in EVERY "
            "group).",
        ),
        CodeInfo(
            "MPX106", "send/recv type-signature mismatch", ERROR,
            "The two sides of a sendrecv (or a matched send/recv pair) "
            "disagree in dtype or element count.  MPI's type-signature "
            "rule; under SPMD a count mismatch cannot be routed at all.",
        ),
        CodeInfo(
            "MPX107", "dropped or forked token", ERROR,
            "A collective's output token is never consumed while a later "
            "collective on the same comm threads an older token.  The "
            "ordering the dropped token was meant to pin is silently "
            "lost (and differs between token and notoken modes).",
        ),
        CodeInfo(
            "MPX108", "collective under one branch of cond", ERROR,
            "A lax.cond has collectives in some branches but not others. "
            "If the predicate ever varies across ranks (notoken mode has "
            "no token ordering to save you), participating ranks hang in "
            "the collective while the others skip it.",
        ),
        CodeInfo(
            "MPX109", "payload near algorithm crossover", ADVISORY,
            "Under MPI4JAX_TPU_COLLECTIVE_ALGO=auto this payload lands "
            "within 2x of MPI4JAX_TPU_RING_CROSSOVER_BYTES, so shape-"
            "polymorphic retraces may flip between the butterfly and ring "
            "lowerings nondeterministically (different perf, same math).",
        ),
        CodeInfo(
            "MPX110", "ambiguous FIFO match", ADVISORY,
            "A recv matched while two or more sends were pending on its "
            "(comm, tag).  FIFO picks the oldest; if the sends are not "
            "interchangeable, use distinct tags or a Clone()d comm.",
        ),
        CodeInfo(
            "MPX111", "adjacent fusable collectives not fused", ADVISORY,
            "With MPI4JAX_TPU_FUSION=off, two or more adjacent "
            "collectives share (op, comm, reduction, root) and each fits "
            "the fusion bucket cap: enabling MPI4JAX_TPU_FUSION=auto "
            "would coalesce them into one flat-buffer collective and cut "
            "per-call dispatch + per-collective latency "
            "(docs/overlap.md).",
        ),
        CodeInfo(
            "MPX112", "unpaired async start/wait", ERROR,
            "An async collective's *_start has no matching *_wait on the "
            "token chain (its phases would be dead-code-eliminated "
            "silently — with the watchdog armed, fatally), or a *_wait "
            "ran without a live start (double wait).  Each start pairs "
            "with exactly one wait on the same handle.",
        ),
        CodeInfo(
            "MPX113", "flat algorithm on a multi-host comm", ADVISORY,
            "A comm spanning multiple hosts ran a flat (single-level) "
            "ring or butterfly at a payload above the ring crossover: "
            "every round is then gated on the slowest DCN hop.  The "
            "two-level hierarchical lowering (intra-host over ICI, "
            "inter-host over DCN) was expressible here — let auto pick "
            "it, or force MPI4JAX_TPU_COLLECTIVE_ALGO=hier "
            "(docs/topology.md).",
        ),
        # --- cross-rank schedule codes (analysis/matcher.py + progress.py):
        # whole-program properties over the per-rank schedules the
        # ranks= re-trace (or a hand-built schedule set) provides.
        CodeInfo(
            "MPX120", "cross-rank collective order mismatch", ERROR,
            "Member ranks of one communicator issue different "
            "collectives at the same schedule position, or are mutually "
            "blocked in collectives on different communicators (an "
            "interleave cycle).  Each side waits in a collective its "
            "peers never enter — a hang at run time (ISP/MUST-style "
            "schedule matching makes this decidable statically).",
        ),
        CodeInfo(
            "MPX121", "send/recv deadlock cycle", ERROR,
            "A cycle of ranks each blocked in a point-to-point receive "
            "whose matching send is issued only after the next rank in "
            "the cycle unblocks.  The cycle is rendered rank-by-rank; "
            "it deadlocks under ANY buffering (sends are modeled "
            "buffered, matching this library's deferred pairing), so "
            "the reference runtime hangs too.",
        ),
        CodeInfo(
            "MPX122", "collective/p2p interleave deadlock", ERROR,
            "A dependency cycle mixing collectives and point-to-point: "
            "some ranks wait in a collective while its other members "
            "are blocked in receives (or vice versa).  No schedule "
            "order exists in which every rank progresses.",
        ),
        CodeInfo(
            "MPX123", "orphaned rank", ERROR,
            "A rank is a member of a communicator group but never "
            "issues the collective its peers are matched in: the peers "
            "block in the collective forever.  Classic cause: a "
            "rank-divergent branch that skips a collective on some "
            "ranks only.",
        ),
        CodeInfo(
            "MPX124", "rank-divergent fusion bucketing", ERROR,
            "Member ranks of one fused collective would pack different "
            "flat buffers (member count, packed bytes, or dtype layout "
            "differ): the flat-buffer exchange would ship mismatched "
            "payloads.  Fusion deferral must see the same op sequence "
            "on every rank.",
        ),
        CodeInfo(
            "MPX125", "hierarchical decomposition mismatch", ERROR,
            "A rank's two-level ICI/DCN plan (ops/_hierarchy.py) "
            "disagrees with its peers' for the same collective under "
            "the declared Topology: intra-host and inter-host phases "
            "would pair different groups.  All members must derive the "
            "same (hosts, ranks-per-host) decomposition.",
        ),
        CodeInfo(
            "MPX127", "collective on a drained communicator", ERROR,
            "A collective was issued on a communicator whose world "
            "executed a planned drain past its leave boundary "
            "(resilience/elastic.py graceful drain): the departed ranks "
            "committed their state and exited on purpose, but this "
            "comm's group tables still include them, so the collective "
            "would block on peers that will never arrive.  Collectives "
            "are legal on a draining comm THROUGH the boundary; after "
            "it, use the rebuilt comm mpx.elastic.run provides (or "
            "comm.shrink the drained ranks out by hand).",
        ),
        CodeInfo(
            "MPX126", "collective on a revoked communication epoch", ERROR,
            "A collective was issued on a communicator stamped with an "
            "epoch older than the current one: the world shrank "
            "(resilience/elastic.py revoked the epoch) but this comm "
            "was never rebuilt, so its group tables, mesh binding, and "
            "rank numbering describe the OLD world — dead ranks "
            "included.  Re-enter through mpx.elastic.run (which rebuilds "
            "the comm on recovery) or call comm.shrink(failed, "
            "mesh=...) and re-issue on the result.",
        ),
        # --- AOT pinning codes (aot/pinning.py + aot/invalidation.py):
        CodeInfo(
            "MPX128", "hot loop not pinned", ADVISORY,
            "One trace dispatches the same (op, comm, statics) "
            "collective signature many times — a Python-level hot loop "
            "unrolled into the program, each dispatch paying the full "
            "Python fast path at trace time and the program growing "
            "linearly with the trip count.  mpx.compile would pin the "
            "program to one executable whose call path does no per-call "
            "key work (docs/aot.md).",
        ),
        CodeInfo(
            "MPX129", "stale pinned program", ERROR,
            "A pinned program (mpx.compile) was called after the world "
            "it was compiled for was revoked: a configuration flag or "
            "set_* override changed the config stamp, or the elastic "
            "communication epoch advanced (shrink, grow, drain).  A "
            "pinned executable does no per-call key work and cannot "
            "retrace itself — re-pin (program.repin(), or a fresh "
            "mpx.compile; mpx.elastic.run re-pins step functions "
            "automatically).",
        ),
        # --- static cost-model advisories (analysis/cost.py, the
        # performance critic over the critical-path timing simulation):
        # each is QUANTIFIED by the alpha-beta-gamma model
        # (analysis/costmodel.py) — predicted microseconds and bytes, not
        # heuristics — and only fires under mpx.analyze(..., cost=True) /
        # MPI4JAX_TPU_ANALYZE_COST=on.
        CodeInfo(
            "MPX131", "overlap opportunity", ADVISORY,
            "A blocking collective's result is consumed late enough "
            "that the surrounding independent compute could hide a "
            "substantial fraction of its predicted wire time: the "
            "async split (*_start/*_wait, docs/overlap.md) would "
            "overlap the phases.  The finding quantifies the hideable "
            "microseconds from the cost model's critical-path "
            "simulation.",
        ),
        CodeInfo(
            "MPX132", "fusion opportunity (quantified)", ADVISORY,
            "Adjacent fusable collectives whose coalescing the cost "
            "model prices: one flat-buffer collective replaces N "
            "per-collective alpha rounds, with the predicted savings "
            "stated in bytes and microseconds — the quantified upgrade "
            "of the MPX111 heuristic (set MPI4JAX_TPU_FUSION=auto, "
            "docs/overlap.md).",
        ),
        CodeInfo(
            "MPX133", "algorithm mispick", ADVISORY,
            "The cost model predicts a different ring/butterfly/hier "
            "lowering than resolve_algo chose for this payload, group "
            "size, and host topology, by more than the mispick "
            "threshold; the finding states the predicted delta.  "
            "Usually a crossover flag "
            "(MPI4JAX_TPU_RING_CROSSOVER_BYTES / _DCN_CROSSOVER_BYTES) "
            "sitting far from the measured value — recalibrate with "
            f"{CALIBRATE_COMMAND}.",
        ),
        CodeInfo(
            "MPX134", "structural load imbalance", ADVISORY,
            "Member ranks of one matched collective carry different "
            "payload bytes, so the widest rank is a straggler BY "
            "CONSTRUCTION — every other member waits out the predicted "
            "delta each step.  Pad or re-shard the payload so matched "
            "members ship equal bytes.",
        ),
        CodeInfo(
            "MPX135", "serialized point-to-point chain", ADVISORY,
            "An unpipelined send/recv ladder occupies the predicted "
            "critical path: each hop waits for the previous stage's "
            "full compute + transfer, so the chain's stages run "
            "serially.  Split the batch into microbatches (GPipe-style) "
            "so stage i+1's transfer overlaps stage i's compute — see "
            f"{PIPELINE_EXAMPLE}.",
        ),
        CodeInfo(
            "MPX136", "batch dimension outside the serving bucket set",
            ADVISORY,
            "A serving bucket table is declared "
            "(mpx.serving.declare_buckets — the serving engine scopes "
            "one around its serving loop) but a traced collective's "
            "leading (batch) "
            "dimension is not one of the declared buckets: every "
            "distinct request batch shape traces, compiles, and pins a "
            "SEPARATE program, so serving pays an unpinned retrace per "
            "request count instead of one program per (bucket, phase).  "
            "Pad the live batch up to its covering bucket "
            "(BucketTable.bucket_for / pad) before dispatch "
            "(docs/serving.md).",
        ),
        CodeInfo(
            "MPX137", "flat alltoall on a multi-host comm", ADVISORY,
            "A comm spanning multiple hosts ran a flat (single-level) "
            "alltoall at a payload above "
            "MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES while the two-level "
            "hierarchical lowering was expressible: every rank "
            "addresses every remote rank directly, paying r times the "
            "DCN message count of the hierarchical split (intra-host "
            "transpose over ICI, inter-host exchange of host-aggregated "
            "contiguous blocks over DCN — ops/_hierarchy.py).  The "
            "MPX113 analog for the permutation family; let auto pick "
            "the hierarchy, or force MPI4JAX_TPU_COLLECTIVE_ALGO=hier "
            "(docs/moe.md).",
        ),
        CodeInfo(
            "MPX138", "uncompressed DCN leg above the crossover", ADVISORY,
            "A hierarchical collective on a multi-host comm ships a "
            "float32 inter-host (DCN) leg above "
            "MPI4JAX_TPU_DCN_CROSSOVER_BYTES uncompressed while the "
            "wire codec layer is off: MPI4JAX_TPU_COMPRESS=bf16 halves "
            "the DCN wire bytes (fp8 quarters them, with per-chunk "
            "scales) at the cost of bit-identity — the error-feedback "
            "accumulator (mpx.compress.ef_allreduce) carries the "
            "rounding residual across steps, and the convergence "
            "harness (BENCH_compress.json) is the parity contract.  "
            "Opt-in and off by default; let mpx.autotune() sweep the "
            "codecs against the error budget (docs/compression.md).",
        ),
        CodeInfo(
            "MPX130", "async span straddles a megastep loop boundary", ERROR,
            "An async *_start/*_wait span crosses a megastep loop "
            "boundary (mpx.compile/mpx.spmd unroll=N, "
            "parallel/megastep.py): the loop body traces once, so a "
            "start whose wait is not in the same iteration leaves every "
            "iteration's collective phases un-awaited at run time — "
            "instrumentation armed with nothing to disarm it, phases "
            "dead-code-eliminated out of the carry.  Keep each span "
            "inside one iteration (overlap is per-iteration in a "
            "megastep), or drop unroll= for this program.",
        ),
        # --- dataflow hazard codes (analysis/dataflow.py + hazards.py):
        # value-level safety over the closed jaxpr joined with the
        # recorded dispatch graph — races, donation, and lineage taint,
        # not schedule structure.
        CodeInfo(
            "MPX139", "buffer mutated while an async span holds it", ERROR,
            "A buffer was donated (or rebound in place) while an open "
            "async *_start/*_wait span still holds it: the span's "
            "exchange phases read the buffer after the start, so a "
            "donation or in-place update between start and wait is a "
            "write-after-start race — the wire may ship the OVERWRITTEN "
            "bytes.  This includes spans crossing mpx.overlap() region "
            "boundaries and fusion LazyResults aliasing bucket members.  "
            "Wait on the handle (or leave the overlap region) before "
            "donating or rebinding the buffer.",
        ),
        CodeInfo(
            "MPX140", "value consumed after donation", ERROR,
            "A value was consumed by a later collective after the pinned "
            "call (mpx.compile donate_argnums) that donated its buffer, "
            "within one trace: the donated buffer's storage is handed to "
            "the executable, so the later read sees freed or aliased "
            "memory.  Drop the stale reference and use the pinned "
            "program's OUTPUT, or remove the argument from "
            "donate_argnums (docs/aot.md).",
        ),
        CodeInfo(
            "MPX141", "rank-local lineage shapes the collective schedule",
            ERROR,
            "A rank-local (non-replicated) value — a Get_rank-derived "
            "scalar, an error-feedback residual, any lineage that "
            "differs per rank — flows into a predicate that gates "
            "collectives (lax.cond/switch with communicating branches "
            "that differ): the schedule itself then diverges across "
            "ranks, the hang class the cross-rank pass only catches "
            "after re-tracing every rank.  Replicate the value first "
            "(allreduce it) or make the branch structure rank-invariant "
            "(docs/sharp_bits.md).",
        ),
        CodeInfo(
            "MPX142", "approximate lineage reaches an exactness-required "
            "sink", ADVISORY,
            "A value carrying approximate (wire-codec) lineage — it "
            "passed through a quantize/dequantize roundtrip (bf16/fp8, "
            "ops/_compress.py) — reaches a sink that assumes exact "
            "arithmetic: a collective root or routing index, an MoE "
            "capacity count, a branch predicate, or shard-store commit "
            "bytes.  Quantization error can flip the decision "
            "differently per rank or corrupt committed state; the "
            "finding renders the taint frontier op by op.  Derive the "
            "decision from exact values, or carry the error through "
            "error feedback (docs/compression.md).",
        ),
        # --- health-plane codes (telemetry/health.py):
        CodeInfo(
            "MPX143", "flight ring smaller than one iteration's "
            "collectives", ADVISORY,
            "The health plane's flight recorder (MPI4JAX_TPU_HEALTH=on) "
            "keeps the most recent MPI4JAX_TPU_FLIGHT_RING records, but "
            "one iteration of this program's loop dispatches more "
            "collectives than the ring holds: by the time a hang is "
            "detected, the ring has already overwritten the iteration's "
            "own history, so a postmortem bundle cannot show where the "
            "ranks diverged.  Raise MPI4JAX_TPU_FLIGHT_RING above the "
            "per-iteration collective count (with headroom for begin + "
            "end records per op) or the bundles will only answer 'what "
            "ran last', not 'who was stuck where' "
            "(docs/observability.md).",
        ),
        # --- pipeline-schedule codes (analysis/cost.py pipeline pass):
        CodeInfo(
            "MPX144", "pipeline runs a schedule the cost model prices "
            "worse", ADVISORY,
            "A pipeline program (mpx.pipeline) ran with a schedule the "
            "cost model prices measurably worse than an expressible "
            "alternative at this (stages, microbatches, payload) point: "
            "the predicted wall time of the chosen schedule exceeds the "
            "best candidate's by more than the mispick threshold.  Pass "
            "schedule='auto' to let the model pick, or switch to the "
            "named schedule in the finding (docs/pipeline.md).",
        ),
    )
}

# the dataflow-hazard code families, referenced by Report.hazards and the
# ownership accounting in tests/test_analysis_pure.py: the graph half
# (checker-registered in analysis/hazards.py) and the jaxpr half (emitted
# by the analysis/dataflow.py walker, like MPX108).
HAZARD_GRAPH_CODES = ("MPX139", "MPX140")
HAZARD_JAXPR_CODES = ("MPX141", "MPX142")
HAZARD_CODES = HAZARD_GRAPH_CODES + HAZARD_JAXPR_CODES


def mpx_error(exc_type, code: str, message: str):
    """Build an exception tagged with a stable MPX code.

    The code rides along as ``exc.mpx_code`` (so ``mpx.analyze`` can
    convert the raise into a :class:`Finding`) and is appended to the
    message (so plain tracebacks are greppable).  Raise sites use this
    instead of bare ``raise TypeError(...)`` for every rule the checker
    catalog covers.
    """
    assert code in CODES, f"unknown MPX code {code}"
    exc = exc_type(f"{message} [{code}]")
    exc.mpx_code = code
    return exc


@dataclass(frozen=True)
class Finding:
    """One diagnostic: a stable code, a one-line message, a suggested fix.

    ``rank`` and ``seq`` are the cross-rank provenance fields (which
    rank's schedule anchors the finding, and at which per-comm collective
    sequence number) — ``None`` for single-trace findings.

    ``frontier`` is the taint frontier of a dataflow-hazard finding
    (MPX141/MPX142): the op-by-op path from the lineage seed to the
    sink, one human-readable step per entry.  Empty for every other
    finding, and emitted in ``to_json`` only when non-empty, so
    pre-hazard payloads are byte-identical."""

    code: str
    message: str
    suggestion: str = ""
    op: Optional[str] = None
    index: Optional[int] = None
    rank: Optional[int] = None
    seq: Optional[int] = None
    frontier: Tuple[str, ...] = ()

    @property
    def severity(self) -> str:
        return CODES[self.code].severity

    def render(self) -> str:
        where = f" at {self.op}#{self.index}" if self.op is not None else ""
        if self.rank is not None:
            where += f" (rank {self.rank})"
        line = f"{self.code} [{self.severity}]{where}: {self.message}"
        for step in self.frontier:
            line += f"\n    taint: {step}"
        if self.suggestion:
            line += f"\n    fix: {self.suggestion}"
        return line

    def to_json(self) -> Dict:
        """Machine-readable form (one object per finding, with rank/op/
        seq provenance) — the unit of ``Report.to_json``."""
        out = {
            "code": self.code,
            "severity": self.severity,
            "title": CODES[self.code].title,
            "message": self.message,
            "suggestion": self.suggestion,
            "op": self.op,
            "index": self.index,
            "rank": self.rank,
            "seq": self.seq,
        }
        if self.frontier:
            # present only on taint findings: every other payload keeps
            # its pre-hazard key set byte-for-byte
            out["frontier"] = list(self.frontier)
        return out


def finding_from_exception(exc) -> Optional[Finding]:
    """Convert an ``mpx_error``-tagged exception into a Finding (or None
    for untagged exceptions, which should propagate)."""
    code = getattr(exc, "mpx_code", None)
    if code is None:
        return None
    return Finding(code=code, message=str(exc),
                   suggestion=CODES[code].doc.split(".")[0] + ".")


@dataclass(frozen=True)
class Report:
    """Result of one analysis pass: the findings, the event stream they
    were derived from (``events`` entries are
    :class:`~mpi4jax_tpu_torch.analysis.graph.CollectiveEvent`), and the
    config snapshot the checkers saw (``meta``).

    ``cost`` is the critical-path timing prediction
    (:class:`~mpi4jax_tpu_torch.analysis.cost.CostReport`) when the pass
    ran (``cost=True``, ``MPI4JAX_TPU_ANALYZE_COST=on``), ``None``
    otherwise, keeping the report and its JSON shape those of a run
    without the cost model."""

    findings: Tuple[Finding, ...] = ()
    events: Tuple = ()
    meta: Dict = field(default_factory=dict)
    cost: Optional[object] = None

    @property
    def ok(self) -> bool:
        return not self.findings

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == ERROR)

    @property
    def advisories(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == ADVISORY)

    @property
    def hazards(self) -> Tuple[Finding, ...]:
        """The dataflow-hazard findings (MPX139-MPX142): races, donation
        violations, and lineage taint — the value-level subset of
        ``findings``."""
        return tuple(f for f in self.findings if f.code in HAZARD_CODES)

    def render(self) -> str:
        if not self.findings:
            head = (f"mpx.analyze: clean ({len(self.events)} collective(s) "
                    "analyzed)")
            if self.cost is not None:
                head += "\n" + self.cost.render()
            return head
        head = (f"mpx.analyze: {len(self.errors)} error(s), "
                f"{len(self.advisories)} advisory(ies) over "
                f"{len(self.events)} collective(s)")
        lines = [head] + [f.render() for f in self.findings]
        if self.cost is not None:
            lines.append(self.cost.render())
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()

    def to_json(self) -> Dict:
        """CI-consumable payload: counts, the config snapshot, and one
        object per finding with rank/op/seq provenance (printed by
        ``python -m mpi4jax_tpu_torch.analysis --json``)."""
        codes: Dict[str, int] = {}
        for f in self.findings:
            codes[f.code] = codes.get(f.code, 0) + 1
        meta = {}
        for k, v in self.meta.items():
            if isinstance(v, (str, int, float, bool)) or v is None:
                meta[k] = v
            elif isinstance(v, (list, tuple)):
                meta[k] = [x if isinstance(x, (str, int, float, bool))
                           else repr(x) for x in v]
            else:
                meta[k] = repr(v)
        payload = {
            "ok": self.ok,
            "errors": len(self.errors),
            "advisories": len(self.advisories),
            "events": len(self.events),
            "codes": codes,
            "meta": meta,
            "findings": [f.to_json() for f in self.findings],
        }
        if self.cost is not None:
            # only present when the cost pass ran: cost=off payloads stay
            # byte-identical to a build without the cost model
            payload["cost"] = self.cost.to_json()
        return payload

    def raise_if_findings(self) -> None:
        if self.findings:
            raise AnalysisError(self.findings, self.render())


class AnalysisError(RuntimeError):
    """Raised by ``MPI4JAX_TPU_ANALYZE=error`` (and
    ``Report.raise_if_findings``) when any finding fired.  The structured
    findings are available as ``.findings``."""

    def __init__(self, findings, message):
        super().__init__(message)
        self.findings = tuple(findings)
