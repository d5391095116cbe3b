"""Progress checking: simulate the matched schedules to a fixed point.

Runs the matched whole-program (analysis/matcher.py) under this
library's execution semantics — buffered sends (deferred pairing: a send
never blocks), receives blocking until the matching send is *issued*,
collectives synchronizing every member, ``*_wait`` blocking until every
member issued its paired ``*_start`` — and advances every rank's program
counter until nothing moves.  A non-empty residue is a deadlock: the
wait-for graph over the blocked ranks is built and its cycles are
reported, classified by what the cycle's ranks are blocked in:

- all point-to-point  -> **MPX121** (send/recv deadlock cycle, rendered
  rank-by-rank: who is blocked where, waiting on whom);
- all collectives     -> **MPX120** (cross-rank collective order
  mismatch: e.g. two comms' collectives interleaved in opposite orders);
- mixed               -> **MPX122** (collective/p2p interleave deadlock).

Because sends are modeled buffered, every cycle found here deadlocks
under ANY buffering — no false alarms from send-buffer pressure (the
rendezvous-only hazard class is deliberately out of scope; this
library's in-region sends genuinely never block).  Blocked ranks whose
peer simply never issues the matching op are the matcher's domain
(MPX101/102/123) and are not re-reported here.  Pure Python;
hand-built schedules drive it in the tests.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .matcher import MatchedProgram, inst_key
from .report import Finding
from .schedule import SchedOp

CROSSRANK_CODES = ("MPX121", "MPX122")


def check_progress(matched: MatchedProgram) -> List[Finding]:
    """Simulate ``matched`` to a fixed point; report deadlock cycles
    (and replay the MPX110 FIFO-ambiguity advisory, which is only
    observable at simulated match time)."""
    sim = _Simulation(matched)
    sim.run()
    return sim.deadlock_findings() + sim.ambiguity_findings()


class _Simulation:
    def __init__(self, matched: MatchedProgram):
        self.m = matched
        self.ranks = matched.ranks
        self.ptr: Dict[int, int] = {r: 0 for r in self.ranks}
        # per-channel issue/consume counters (FIFO positions)
        self.sent: Dict[Tuple, int] = {}
        self.recvd: Dict[Tuple, int] = {}
        # wildcard pool: issued-unconsumed send count per (ck, dst, tag)
        self.pool: Dict[Tuple, int] = {}
        # ranks whose *start* for an instance has been issued
        self.started: Dict[Tuple, Set[int]] = {}
        # MPX110 replay: (rank, recv op, pending-send depth) at match
        self.ambiguous: List[Tuple[int, SchedOp, int]] = []
        # per-rank FIFO ordinal of each p2p op (precomputed)
        self.ordinal: Dict[Tuple[int, int], int] = {}  # (rank, pos) -> k
        for r in self.ranks:
            counts: Dict[Tuple, int] = {}
            for op in matched.schedules[r]:
                if op.kind == "send":
                    key = ("s", op.comm_key, op.src, op.dst, op.tag)
                elif op.kind == "recv" and op.src is not None:
                    key = ("r", op.comm_key, op.src, op.dst, op.tag)
                else:
                    continue
                self.ordinal[(r, op.pos)] = counts.get(key, 0)
                counts[key] = counts.get(key, 0) + 1

    def head(self, r: int) -> Optional[SchedOp]:
        sched = self.m.schedules[r]
        return sched[self.ptr[r]] if self.ptr[r] < len(sched) else None

    def _issue_send(self, r: int, op: SchedOp) -> None:
        ch = (op.comm_key, op.src, op.dst, op.tag)
        self.sent[ch] = self.sent.get(ch, 0) + 1
        self.pool[(op.comm_key, op.dst, op.tag)] = self.pool.get(
            (op.comm_key, op.dst, op.tag), 0) + 1

    def _recv_ready(self, r: int, op: SchedOp) -> bool:
        if op.src is None:  # wildcard: any issued-unconsumed send to me
            return self.pool.get((op.comm_key, op.dst, op.tag), 0) > 0
        ch = (op.comm_key, op.src, op.dst, op.tag)
        return self.sent.get(ch, 0) > self.ordinal[(r, op.pos)]

    def _consume_recv(self, r: int, op: SchedOp) -> None:
        key = (op.comm_key, op.dst, op.tag)
        if self.pool.get(key, 0) > 0:
            self.pool[key] -= 1

    def _coll_ready(self, key: Tuple) -> bool:
        """Every expected member's head is this instance."""
        for q in self.m.expected.get(key, ()):
            h = self.head(q)
            if h is None or h.kind != "coll" or inst_key(h) != key:
                return False
        return True

    def _wait_ready(self, key: Tuple) -> bool:
        """Every expected member has issued its paired start."""
        exp = self.m.expected.get(key, ())
        return all(q in self.started.get(key, set()) for q in exp)

    def run(self) -> None:
        moved = True
        while moved:
            moved = False
            for r in self.ranks:
                while True:
                    op = self.head(r)
                    if op is None:
                        break
                    if op.kind == "send":
                        self._issue_send(r, op)
                        self.ptr[r] += 1
                        self._retire_send(r, op)
                    elif op.kind == "recv":
                        if not self._recv_ready(r, op):
                            break
                        self._note_ambiguity(r, op)
                        self._consume_recv(r, op)
                        self.ptr[r] += 1
                        self._retire_recv(r, op)
                    elif op.kind == "start":
                        # nonblocking issue: record it for the paired
                        # wait's readiness check and move on
                        self.started.setdefault(
                            inst_key(op), set()).add(r)
                        self.ptr[r] += 1
                        self._retire_start(r, op)
                    elif op.kind == "coll":
                        key = inst_key(op)
                        if not self._coll_ready(key):
                            break
                        members = self.m.expected.get(key, (r,))
                        for q in members:
                            self.ptr[q] += 1
                        self._retire_coll(key, members)
                    elif op.kind == "wait":
                        if not self._wait_ready(inst_key(op)):
                            break
                        self.ptr[r] += 1
                        self._retire_wait(r, op)
                    else:  # unknown kinds never block
                        self.ptr[r] += 1
                    moved = True

    # -- retirement hooks --------------------------------------------------
    # The timed (critical-path) simulation in analysis/cost.py subclasses
    # this simulation and overrides these: each is invoked exactly once,
    # at the moment the op retires under the SAME buffered-send execution
    # semantics the deadlock verdicts use — so predicted timings and
    # progress verdicts can never disagree about what runs when.  A coll
    # retires all member ranks together (one call, ``members`` in rank
    # order); everything else retires per rank.

    def _retire_send(self, r: int, op: SchedOp) -> None:
        pass

    def _retire_recv(self, r: int, op: SchedOp) -> None:
        pass

    def _retire_start(self, r: int, op: SchedOp) -> None:
        pass

    def _retire_coll(self, key: Tuple, members) -> None:
        pass

    def _retire_wait(self, r: int, op: SchedOp) -> None:
        pass

    def _note_ambiguity(self, r: int, op: SchedOp) -> None:
        """MPX110 replay (the single-trace FIFO-ambiguity advisory, which
        the per-rank pass skips): this recv is about to match while >= 2
        sends sit unconsumed on its channel — FIFO picks the oldest."""
        if op.src is None:
            depth = self.pool.get((op.comm_key, op.dst, op.tag), 0)
        else:
            ch = (op.comm_key, op.src, op.dst, op.tag)
            depth = self.sent.get(ch, 0) - self.ordinal[(r, op.pos)]
        if depth >= 2:
            self.ambiguous.append((r, op, depth))

    def ambiguity_findings(self) -> List[Finding]:
        return [
            Finding(
                code="MPX110", op=op.op, index=op.event_index, rank=r,
                message=(f"rank {r}'s recv(tag={op.tag}) matched while "
                         f"{depth} sends were pending on its channel; "
                         "FIFO picked the oldest"),
                suggestion=("use distinct tags (or a Clone()d comm) if "
                            "the pending sends are not interchangeable"),
            )
            for r, op, depth in self.ambiguous
        ]

    # -- deadlock analysis -------------------------------------------------

    def _block_targets(self, r: int, op: SchedOp) -> List[int]:
        """Ranks ``r`` is waiting on (edges of the wait-for graph).
        Empty when the block is a never-issued-op case the matcher
        already reported (MPX101/102/123)."""
        if op.kind == "recv":
            if op.src is None:
                # any rank still holding an unissued send to (dst, tag)
                out = []
                for q in self.ranks:
                    for s in self.m.schedules[q][self.ptr[q]:]:
                        if (s.kind == "send" and s.comm_key == op.comm_key
                                and s.dst == op.dst and s.tag == op.tag):
                            out.append(q)
                            break
                return out
            # the specific sender, if its matching send is still ahead
            q = op.src
            if q not in self.ptr:
                return []
            need = self.ordinal[(r, op.pos)]
            seen = 0
            for s in self.m.schedules[q][:self.ptr[q]]:
                if (s.kind == "send" and s.comm_key == op.comm_key
                        and s.dst == op.dst and s.tag == op.tag):
                    seen += 1
            remaining = sum(
                1 for s in self.m.schedules[q][self.ptr[q]:]
                if (s.kind == "send" and s.comm_key == op.comm_key
                    and s.dst == op.dst and s.tag == op.tag)
            )
            return [q] if seen + remaining > need else []
        if op.kind in ("coll", "wait"):
            key = inst_key(op)
            out = []
            for q in self.m.expected.get(key, ()):
                if q == r:
                    continue
                if op.kind == "wait" and q in self.started.get(key, set()):
                    continue
                h = self.head(q)
                if h is not None and (h.kind != "coll"
                                      or inst_key(h) != key):
                    out.append(q)
            return out
        return []

    def deadlock_findings(self) -> List[Finding]:
        blocked = {r: self.head(r) for r in self.ranks
                   if self.head(r) is not None}
        if not blocked:
            return []
        edges = {r: self._block_targets(r, op)
                 for r, op in blocked.items()}
        findings: List[Finding] = []
        seen_cycles: Set[Tuple[int, ...]] = set()
        for start in sorted(blocked):
            cycle = _find_cycle(edges, start)
            if cycle is None:
                continue
            canon = tuple(sorted(cycle))
            if canon in seen_cycles:
                continue
            seen_cycles.add(canon)
            kinds = {blocked[r].kind for r in cycle}
            if kinds <= {"recv", "send"}:
                code = "MPX121"
                label = "send/recv deadlock cycle"
            elif kinds <= {"coll", "start", "wait"}:
                code = "MPX120"
                label = ("cross-rank collective order mismatch "
                         "(collectives interleaved in conflicting orders)")
            else:
                code = "MPX122"
                label = "collective/p2p interleave deadlock"
            chain = "; ".join(
                f"rank {r}: blocked at {blocked[r].describe()} "
                f"(schedule position {blocked[r].pos}) -> waits for "
                f"rank {cycle[(i + 1) % len(cycle)]}"
                for i, r in enumerate(cycle)
            )
            first = cycle[0]
            findings.append(Finding(
                code=code, op=blocked[first].op,
                index=blocked[first].event_index, rank=first,
                seq=blocked[first].seq,
                message=f"{label} over ranks {sorted(cycle)}: {chain}",
                suggestion=("break the cycle: reorder one rank's ops so "
                            "some rank's blocking op is matched first "
                            "(e.g. pair the exchange with sendrecv, or "
                            "hoist the collective out of the divergent "
                            "branch)"),
            ))
        return findings


def _find_cycle(edges: Dict[int, List[int]], start: int) -> Optional[List[int]]:
    """A cycle reachable from ``start`` in the wait-for graph, as the
    ordered rank list of the cycle itself (path prefix trimmed)."""
    path: List[int] = []
    on_path: Set[int] = set()
    seen: Set[int] = set()

    def dfs(r: int) -> Optional[List[int]]:
        if r in on_path:
            return path[path.index(r):]
        if r in seen:
            return None
        seen.add(r)
        path.append(r)
        on_path.add(r)
        for q in edges.get(r, ()):
            got = dfs(q)
            if got is not None:
                return got
        path.pop()
        on_path.remove(r)
        return None

    return dfs(start)
