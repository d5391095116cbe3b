"""Graph-side dataflow hazard checkers: donation races, use-after-donate.

The graph half of ``mpi4jax_tpu/analysis/hazards.py``, the port's own
copy.  These checkers join the recorded event stream with the *donation
records* a pinned program leaves in ``graph.meta["donations"]``
(``aot/pinning.py``: one ``(pos, buffer_ids, where)`` entry per call of a
pin with ``donate_argnums``, ``pos`` the event-stream position the
donation happened at) and the per-event ``buffers`` identity tuples the
dispatch hook records (``analysis/hook.py``):

MPX139 (ERROR)
    A donation lands while an async ``*_start``/``*_wait`` span still
    holds one of the donated buffers: the span's exchange reads the
    buffer after the start, so handing its storage to a pinned program
    between start and wait is a write-after-start race.

MPX140 (ERROR)
    A collective consumes a buffer whose storage an earlier pinned call
    of the same run already donated: the read sees freed or aliased
    memory.

Buffer identities are ``id()``s of the carriers, pinned alive by the
recorder for the recording's lifetime; checkers use them purely as
equality handles and never print them.  The value-lineage half is
:func:`hazard_findings`: the dataflow pass (``dataflow.py``, MPX141/MPX142)
over a run's lineage record (``lineage.py``), armed by its graph.

Pure Python: hand-built graphs drive both checkers in the tests.
"""

from __future__ import annotations

from typing import List, Optional

from .checkers import checker
from .dataflow import graph_arms_approx, hazard_jaxpr_findings
from .graph import CollectiveGraph
from .report import Finding


def hazard_findings(record, graph=None,
                    rank: Optional[int] = None) -> List[Finding]:
    """The lineage half in one call: MPX141/MPX142 over a run's lineage
    ``record``, with the approximate seeds armed by the recorded
    ``graph``'s codec or error-feedback activity."""
    return hazard_jaxpr_findings(
        record, approx_armed=graph_arms_approx(graph), rank=rank)


def _span_intervals(graph: CollectiveGraph) -> dict:
    """span id -> [start_pos, wait_pos or None, held buffer ids, start
    event], by stream position (event stream positions and donation
    ``pos`` values share one clock: ``len(events)`` at record time)."""
    spans: dict = {}
    for pos, e in enumerate(graph.events):
        if e.span is None:
            continue
        if e.op.endswith("_start"):
            held = set(getattr(e, "buffers", ()) or ())
            spans[e.span] = [pos, None, held, e]
        elif e.op.endswith("_wait"):
            rec = spans.get(e.span)
            if rec is not None and rec[1] is None:
                rec[1] = pos
    return spans


@checker("MPX139")
def check_span_donation_race(graph: CollectiveGraph) -> List[Finding]:
    """Donation while an open async span holds the buffer."""
    donations = graph.meta.get("donations", ())
    if not donations:
        return []
    spans = _span_intervals(graph)
    findings: List[Finding] = []
    for dpos, ids, where in donations:
        for span_id, (spos, wpos, held, start) in sorted(spans.items()):
            if spos >= dpos:
                continue  # span opened after the donation landed
            if wpos is not None and wpos < dpos:
                continue  # span already waited — buffer released
            if held & set(ids):
                findings.append(Finding(
                    code="MPX139", op=start.op, index=start.index,
                    message=(f"{where} donates a buffer the open async "
                             f"span {span_id} ({start.where()}) still "
                             "holds: the span's exchange phases read it "
                             "after the start, so the wire may ship the "
                             "overwritten bytes (write-after-start "
                             "race)"),
                    suggestion=("wait on the handle "
                                f"({start.op.replace('_start', '_wait')})"
                                " — or leave the mpx.overlap() region — "
                                "before the donating call"),
                ))
    return findings


@checker("MPX140")
def check_use_after_donate(graph: CollectiveGraph) -> List[Finding]:
    """Collective consuming a buffer a pinned call already donated."""
    donations = graph.meta.get("donations", ())
    if not donations:
        return []
    findings: List[Finding] = []
    for pos, e in enumerate(graph.events):
        bufs = set(getattr(e, "buffers", ()) or ())
        if not bufs:
            continue
        for dpos, ids, where in donations:
            if dpos <= pos and bufs & set(ids):
                findings.append(Finding(
                    code="MPX140", op=e.op, index=e.index,
                    message=(f"{e.where()} consumes a buffer whose "
                             f"storage {where} already donated to its "
                             "executable: the read sees freed or "
                             "aliased memory"),
                    suggestion=("use the pinned program's OUTPUT instead "
                                "of the stale donated reference, or drop "
                                "the argument from donate_argnums "
                                "(docs/aot.md)"),
                ))
                break
    return findings
