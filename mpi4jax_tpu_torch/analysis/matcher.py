"""Global schedule matching: pair every op across the per-rank schedules.

ISP/MUST-style whole-program matching over the per-rank
:class:`~.schedule.SchedOp` schedules:

- **collectives** match by ``(comm_key, seq)`` across all member ranks:
  the k-th collective a rank issues on a comm must be the SAME operation
  (kind, root, reduction, member group) every other member issues as its
  k-th — a signature disagreement is MPX120, a member that never arrives
  is MPX123, divergent fusion packing is MPX124, and a divergent
  two-level hierarchy plan is MPX125;
- **point-to-point** matches by ``(comm_key, src, dst, tag)`` channel
  with FIFO (non-overtaking) semantics: the k-th send on a channel pairs
  with the k-th receive.  Count/type mismatches reuse the established
  codes cross-rank: a send no rank ever receives is MPX101, a receive no
  rank ever sends to is MPX102, a paired send/recv whose dtype or
  element count disagree is MPX106;
- **async** ``*_start``/``*_wait`` pairs arrive already span-linked by
  the schedule builder (the start carries the instance's seq; the wait
  references it), so they match like collectives.

The matcher is purely structural; ordering-dependent hangs (cycles) are
the progress checker's job (analysis/progress.py) over the
:class:`MatchedProgram` built here.  Pure Python.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .report import Finding
from .schedule import SchedOp

# codes this module owns in the checker-coverage sense (MPX101/102/106
# are reused from the single-trace catalog with cross-rank messages)
CROSSRANK_CODES = ("MPX120", "MPX123", "MPX124", "MPX125")


def inst_key(op: SchedOp) -> Tuple:
    """Matching identity of a collective instance: on a color-split comm
    one traced op is a SEPARATE exchange per member group, so the
    participants claim is part of the key (two groups of one comm never
    match each other — and never deadlock each other)."""
    return (op.comm_key, op.seq, op.participants)


@dataclass
class MatchedProgram:
    """The matched whole-program view the progress checker consumes."""

    schedules: Dict[int, List[SchedOp]]
    # inst_key -> {rank: its coll/start op}
    instances: Dict[Tuple, Dict[int, SchedOp]]
    # inst_key -> {rank: its wait op}
    waits: Dict[Tuple, Dict[int, SchedOp]]
    # inst_key -> sorted expected member ranks (∩ analyzed)
    expected: Dict[Tuple, Tuple[int, ...]]
    # (comm_key, src, dst, tag) -> ([send ops], [explicit recv ops])
    channels: Dict[Tuple[int, int, int, Optional[int]],
                   Tuple[List[SchedOp], List[SchedOp]]]
    # (comm_key, dst, tag) -> [wildcard recv ops]
    wildcards: Dict[Tuple[int, int, Optional[int]], List[SchedOp]]
    findings: List[Finding] = field(default_factory=list)

    @property
    def ranks(self) -> Tuple[int, ...]:
        return tuple(sorted(self.schedules))


def match_schedules(schedules: Dict[int, List[SchedOp]]) -> MatchedProgram:
    """Match ``schedules`` (rank -> ordered SchedOps) and report every
    structural mismatch; the analyzed rank set is ``schedules``' keys
    (membership checks are restricted to it, so analyzing a subset of a
    comm never false-positives the absent ranks)."""
    analyzed = set(schedules)
    instances: Dict[Tuple, Dict[int, SchedOp]] = {}
    waits: Dict[Tuple, Dict[int, SchedOp]] = {}
    channels: Dict = {}
    wildcards: Dict = {}
    coll_counts: Dict[Tuple[int, int], int] = {}  # (rank, comm_key)
    at_rank: Dict[Tuple[int, int, int], SchedOp] = {}  # (rank, ck, seq)

    for r in sorted(schedules):
        for op in schedules[r]:
            if op.kind in ("coll", "start"):
                instances.setdefault(inst_key(op), {})[r] = op
                k = (r, op.comm_key)
                coll_counts[k] = coll_counts.get(k, 0) + 1
                at_rank[(r, op.comm_key, op.seq)] = op
            elif op.kind == "wait":
                waits.setdefault(inst_key(op), {})[r] = op
            elif op.kind == "send":
                ch = channels.setdefault(
                    (op.comm_key, op.src, op.dst, op.tag), ([], []))
                ch[0].append(op)
            elif op.kind == "recv":
                if op.src is None:
                    wildcards.setdefault(
                        (op.comm_key, op.dst, op.tag), []).append(op)
                else:
                    ch = channels.setdefault(
                        (op.comm_key, op.src, op.dst, op.tag), ([], []))
                    ch[1].append(op)

    findings: List[Finding] = []
    expected: Dict[Tuple, Tuple[int, ...]] = {}
    orphaned: set = set()       # (comm_key, rank) reported once
    group_mismatch: set = set()  # (comm_key, seq) reported once

    for key in sorted(instances, key=str):
        ck, seq, parts = key
        present = instances[key]
        members: set = (set(parts) if parts is not None else set(present))
        exp = tuple(sorted(members & analyzed))
        expected[key] = exp

        # member-group agreement: a rank this cluster claims that issued
        # its (ck, seq)-th collective with a DIFFERENT group claim
        for q in exp:
            other = at_rank.get((q, ck, seq))
            if (other is None or other.participants == parts
                    or other.participants is None
                    or (ck, seq) in group_mismatch):
                continue
            group_mismatch.add((ck, seq))
            first = present[min(present)]
            findings.append(Finding(
                code="MPX120", op=first.op, index=first.event_index,
                rank=min(present), seq=seq,
                message=(f"collective #{seq} on comm {first.comm_uid} "
                         "diverges across ranks: rank(s) "
                         f"{sorted(present)} pair group {parts} while "
                         f"rank {q} pairs group {other.participants} — "
                         "the groups never match each other"),
                suggestion=("derive the member groups from shared static "
                            "structure (the same Split tables on every "
                            "rank)"),
            ))

        # signature agreement across the matched members (MPX120)
        sigs: Dict[Tuple, List[int]] = {}
        for r in sorted(present):
            op = present[r]
            sig = (op.op, op.root, op.reduction)
            sigs.setdefault(sig, []).append(r)
        if len(sigs) > 1:
            first = present[min(present)]
            detail = "; ".join(
                f"rank(s) {rs} issue {s[0]}"
                + (f" root={s[1]}" if s[1] is not None else "")
                + (f" reduction={s[2]}" if s[2] is not None else "")
                for s, rs in sorted(sigs.items(), key=lambda kv: kv[1])
            )
            findings.append(Finding(
                code="MPX120", op=first.op, index=first.event_index,
                rank=min(present), seq=seq,
                message=(f"collective #{seq} on comm {first.comm_uid} "
                         f"diverges across ranks: {detail} — each side "
                         "waits in a collective its peers never enter"),
                suggestion=("make every member rank issue the same "
                            "collective sequence on this comm (hoist the "
                            "divergent branch, or split the comm)"),
            ))

        # fusion packing agreement (MPX124)
        fsigs = {op.fused for op in present.values() if op.fused is not None}
        if len(fsigs) > 1:
            first = present[min(present)]
            per_rank = ", ".join(
                f"rank {r}: {present[r].fused[0]} member(s) / "
                f"{present[r].fused[1]} B"
                for r in sorted(present) if present[r].fused is not None
            )
            findings.append(Finding(
                code="MPX124", op=first.op, index=first.event_index,
                rank=min(present), seq=seq,
                message=(f"fused collective #{seq} on comm "
                         f"{first.comm_uid} packs different flat buffers "
                         f"across ranks ({per_rank}): the flat-buffer "
                         "exchange would ship mismatched payloads"),
                suggestion=("issue the same fusable op sequence on every "
                            "rank (rank-divergent branches must not add "
                            "or drop members inside a fusion region)"),
            ))

        # two-level hierarchy plan agreement (MPX125)
        hsigs = {op.hier for op in present.values()}
        if len(hsigs) > 1 and any(h is not None for h in hsigs):
            first = present[min(present)]
            per_rank = ", ".join(
                f"rank {r}: "
                + (f"{present[r].hier[0]}x{present[r].hier[1]}"
                   if present[r].hier is not None else "flat")
                for r in sorted(present)
            )
            findings.append(Finding(
                code="MPX125", op=first.op, index=first.event_index,
                rank=min(present), seq=seq,
                message=(f"collective #{seq} on comm {first.comm_uid} "
                         "derives different two-level ICI/DCN "
                         f"decompositions across ranks ({per_rank}): "
                         "intra-host and inter-host phases would pair "
                         "different groups"),
                suggestion=("declare one topology for every rank "
                            "(MPI4JAX_TPU_TOPOLOGY) and derive the plan "
                            "from the shared mesh — see docs/topology.md"),
            ))

        # orphaned members (MPX123): an expected rank whose schedule on
        # this comm ends before this instance
        for q in exp:
            if q in present or (ck, q) in orphaned:
                continue
            if coll_counts.get((q, ck), 0) <= seq:
                orphaned.add((ck, q))
                first = present[min(present)]
                findings.append(Finding(
                    code="MPX123", op=first.op, index=first.event_index,
                    rank=q, seq=seq,
                    message=(f"rank {q} is a member of comm "
                             f"{first.comm_uid} but never issues "
                             f"collective #{seq} ({first.op}) that "
                             f"rank(s) {sorted(present)} are matched in: "
                             "the peers block forever"),
                    suggestion=("ensure every member rank reaches this "
                                "collective (a rank-divergent branch that "
                                "skips it orphans the group)"),
                ))

    findings.extend(_check_p2p_counts(channels, wildcards))
    findings.sort(key=lambda f: (f.seq if f.seq is not None else -1, f.code))
    return MatchedProgram(schedules=schedules, instances=instances,
                          waits=waits, expected=expected, channels=channels,
                          wildcards=wildcards, findings=findings)


def _check_p2p_counts(channels, wildcards) -> List[Finding]:
    """Channel-count matching: FIFO pairing + MPX106 on paired type
    signatures; surplus sends may be drained by wildcard receives at the
    same (comm, dst, tag) before MPX101 fires."""
    findings: List[Finding] = []
    # surplus sends per (comm_key, dst, tag), candidates for wildcards
    surplus: Dict[Tuple[int, int, Optional[int]], List[SchedOp]] = {}

    for key in sorted(channels):
        ck, src, dst, tag = key
        sends, recvs = channels[key]
        for s, v in zip(sends, recvs):
            if (s.dtype and v.dtype and s.dtype != v.dtype) or (
                    s.nelems is not None and v.nelems is not None
                    and s.nelems != v.nelems):
                findings.append(Finding(
                    code="MPX106", op="recv", index=v.event_index,
                    rank=v.rank,
                    message=(f"rank {dst}'s recv(src={src}, tag={tag}) "
                             f"template ({v.nelems} x {v.dtype}) does not "
                             f"match rank {src}'s send "
                             f"({s.nelems} x {s.dtype}): MPI "
                             "type-signature rule"),
                    suggestion="make both sides agree in dtype and "
                               "element count",
                ))
        for v in recvs[len(sends):]:
            findings.append(Finding(
                code="MPX102", op="recv", index=v.event_index, rank=v.rank,
                message=(f"rank {dst} receives from rank {src} "
                         f"(tag={tag}) more often than rank {src} sends: "
                         f"this recv (schedule position {v.pos}) has no "
                         "matching send on any rank — it blocks forever"),
                suggestion=(f"issue the matching send on rank {src}, or "
                            "drop the recv"),
            ))
        surplus.setdefault((ck, dst, tag), []).extend(sends[len(recvs):])

    for key in sorted(surplus, key=str):
        ck, dst, tag = key
        extra = surplus[key]
        wild = wildcards.get(key, [])
        for s in extra[len(wild):]:
            findings.append(Finding(
                code="MPX101", op="send", index=s.event_index, rank=s.rank,
                message=(f"rank {s.src}'s send to rank {dst} (tag={tag}, "
                         f"schedule position {s.pos}) is never received "
                         "by any rank: the message is lost (the "
                         "reference would deadlock at MPI_Finalize)"),
                suggestion=(f"issue the matching recv on rank {dst}, or "
                            "drop the send"),
            ))
    for key in sorted(wildcards, key=str):
        ck, dst, tag = key
        wild = wildcards[key]
        avail = len(surplus.get(key, []))
        for v in wild[avail:]:
            findings.append(Finding(
                code="MPX102", op="recv", index=v.event_index, rank=v.rank,
                message=(f"rank {dst}'s wildcard recv (tag={tag}, "
                         f"schedule position {v.pos}) has no remaining "
                         "unmatched send from any rank"),
                suggestion="issue a matching send on some rank, or drop "
                           "the recv",
            ))
    return findings
