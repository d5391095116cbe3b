"""Per-rank schedules: the cross-rank verifier's program model.

The port's own copy of ``mpi4jax_tpu/analysis/schedule.py``.  Classic MPI
verifiers (ISP / MUST-style schedule matching) show that cross-rank
hangs (mismatched collective orders, send/recv cycles, orphaned group
members) are decidable statically from each rank's *ordered op
schedule*.  This module provides the two halves every front-end shares:

- the **rank-concretization scope**: while ``analyze(ranks=...)`` (or the
  ambient cross-rank pass) re-runs a program abstractly for one rank,
  ``Comm.Get_rank`` returns that rank as a :class:`RankConcrete`, and
  ``Comm.axis_index`` and ``Comm.members`` that rank's coordinates and
  peers, so rank-dependent Python branches take their real per-rank
  paths;
- the **schedule builder**: one rank's recorded event stream projected
  onto that rank's ordered :class:`SchedOp` list: collectives keep a
  per-comm sequence number, point-to-point ops keep their (src, dst, tag)
  role, async ``*_start``/``*_wait`` pairs keep their span link.

The execution model downstream (``matcher.py`` + ``progress.py``) is the
library's: sends are **buffered**, receives block until the matching
send is *issued*, collectives synchronize all group members, and a
``*_wait`` blocks until every member has issued its ``*_start``.  A
deadlock found under buffered sends deadlocks under any buffering, so
every cycle reported is a genuine hang.

Pure Python: hand-built schedules drive the matcher and the progress
checker in the tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# op names with point-to-point roles (everything else on the dispatch
# stream is treated as a collective over its comm's member group)
P2P_OPS = ("send", "recv", "sendrecv")


# ---------------------------------------------------------------------------
# rank concretization
# ---------------------------------------------------------------------------


class RankConcrete(int):
    """The concretized rank: an ``int`` for data uses (masks,
    coordinates, Python branching — the whole point of the per-rank
    re-trace), but still *rejected* as a structural argument (roots,
    tags, routing specs) exactly like the traced rank it stands in for:
    structure must be rank-uniform statics, and a per-rank trace must
    not silently accept a program the real trace refuses (MPX104).
    Any arithmetic (``r % 2``, ``r ^ 1``, ``int(r)``) returns a plain
    int, so rank-DERIVED values are ordinary statics."""

    __slots__ = ()


def is_rank_concrete(x) -> bool:
    return isinstance(x, RankConcrete)


class ConcreteScope:
    """Active while one rank's schedule trace runs.

    Holds the region comm's axis names/sizes and the concrete linear
    rank (row-major over those axes, the same order ``Get_rank``
    defines).  ``Comm.Get_rank`` / ``GroupComm.Get_rank`` consult the
    innermost scope and return Python ints, so the traced function's
    rank-dependent branches concretize.
    """

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int],
                 index: int):
        self.names: Tuple[str, ...] = tuple(axis_names)
        self.sizes: Tuple[int, ...] = tuple(int(s) for s in axis_sizes)
        if len(self.names) != len(self.sizes):
            raise ValueError("axis_names and axis_sizes must align")
        world = 1
        for s in self.sizes:
            world *= s
        self.world = world
        if not 0 <= int(index) < world:
            raise ValueError(f"rank index {index} out of range for "
                             f"world {world}")
        self.index = int(index)
        self.coords: Dict[str, int] = dict(
            zip(self.names, _unravel(self.index, self.sizes))
        )


def _unravel(index: int, sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    """Row-major coordinates of ``index`` over ``sizes``."""
    coords = []
    for s in reversed(sizes):
        coords.append(index % s)
        index //= s
    return tuple(reversed(coords))


# thread-local: a per-rank re-run on one thread must never leak its
# concretization into another thread's real run (where a spurious
# ``concretizing()`` would relax send/recv matching).  ``ACTIVE`` counts
# the scopes open on every thread: the communicator reads it first, so a
# process with no scope open pays one list index per ``Get_rank``.
import threading

_tls = threading.local()
ACTIVE = [0]


def _scope_stack() -> List[ConcreteScope]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def concretizing() -> bool:
    """True while a per-rank schedule run is in progress (on this thread):
    send/recv record one-sided (the cross-rank matcher pairs them
    instead), and ``Get_rank`` concretizes."""
    return bool(ACTIVE[0]) and bool(_scope_stack())


def current_scope() -> Optional[ConcreteScope]:
    if not ACTIVE[0]:
        return None
    stack = _scope_stack()
    return stack[-1] if stack else None


class scope:
    """Context manager installing a :class:`ConcreteScope`."""

    def __init__(self, axis_names, axis_sizes, index):
        self._scope = ConcreteScope(axis_names, axis_sizes, index)

    def __enter__(self):
        _scope_stack().append(self._scope)
        ACTIVE[0] += 1
        return self._scope

    def __exit__(self, *exc):
        _scope_stack().pop()
        ACTIVE[0] -= 1
        return False


def scope_coords(axes: Sequence[str]) -> Optional[Tuple[int, ...]]:
    """The active scope's coordinates along ``axes`` (a grid's axes, in
    order), or ``None`` when no scope is active or it does not cover
    them: the communicator's ``members`` and ``axis_index`` take the
    analyzed rank's place on the grid from here."""
    sc = current_scope()
    if sc is None or not set(axes) <= set(sc.coords):
        return None
    return tuple(sc.coords[a] for a in axes)


def concrete_comm_rank(axes: Sequence[str]) -> Optional[RankConcrete]:
    """The active scope's linear rank over ``axes`` (row-major), or
    ``None`` when no scope is active or ``axes`` are not all covered
    (the caller falls back to its grid's own rank)."""
    sc = current_scope()
    if sc is None:
        return None
    sizes = dict(zip(sc.names, sc.sizes))
    rank = 0
    for a in axes:
        if a not in sc.coords:
            return None
        rank = rank * sizes[a] + sc.coords[a]
    return RankConcrete(rank)


# the partition is a pure function of (scope axes, sizes, comm axes) and
# is consulted once per RECORDED EVENT (hook.begin_event) across world
# re-traces — memoized so a region records O(events) dict hits, not
# O(world^2 * events) partition rebuilds
_groups_memo: Dict[Tuple, Tuple[Tuple[int, ...], ...]] = {}
_GROUPS_MEMO_MAX = 64


def groups_for_axes(axes: Sequence[str]) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Member groups (world-linear rank ids, group order) a collective
    over ``axes`` forms inside the active scope's world — the implicit
    partition a sub-axes comm induces (e.g. ``comm.sub("x")`` on a
    ``("y", "x")`` mesh groups ranks by row).  ``None`` when no scope is
    active or ``axes`` are not covered."""
    sc = current_scope()
    if sc is None or not set(axes) <= set(sc.names):
        return None
    memo_key = (sc.names, sc.sizes, tuple(axes))
    cached = _groups_memo.get(memo_key)
    if cached is not None:
        return cached
    sizes = dict(zip(sc.names, sc.sizes))
    buckets: Dict[Tuple[int, ...], List[Tuple[int, int]]] = {}
    for wid in range(sc.world):
        cmap = dict(zip(sc.names, _unravel(wid, sc.sizes)))
        key = tuple(cmap[n] for n in sc.names if n not in axes)
        sub = 0
        for a in axes:
            sub = sub * sizes[a] + cmap[a]
        buckets.setdefault(key, []).append((sub, wid))
    out = tuple(
        tuple(w for _, w in sorted(members))
        for _, members in sorted(buckets.items())
    )
    if len(_groups_memo) >= _GROUPS_MEMO_MAX:
        _groups_memo.clear()
    _groups_memo[memo_key] = out
    return out


# ---------------------------------------------------------------------------
# the schedule model
# ---------------------------------------------------------------------------


@dataclass
class SchedOp:
    """One rank's op at one schedule position.

    ``kind`` is the progress semantics: ``coll`` (synchronizing
    collective), ``send`` (buffered — never blocks), ``recv`` (blocks
    until the matching send is issued; ``src=None`` is a wildcard),
    ``start`` (nonblocking issue), ``wait`` (blocks until every member
    issued the paired start).  ``comm_key`` is the opaque cross-rank
    communicator identity used for matching (``build_schedule`` derives
    it from the uid, normalizing comms created inside the traced
    function by creation order — see its docstring); ``comm_uid`` is
    kept for display.
    """

    rank: int
    pos: int
    kind: str
    op: str
    comm_uid: int = 0
    comm_key: object = 0
    seq: Optional[int] = None
    participants: Optional[Tuple[int, ...]] = None
    src: Optional[int] = None
    dst: Optional[int] = None
    tag: Optional[int] = None
    root: Optional[int] = None
    reduction: Optional[str] = None
    dtype: str = ""
    nelems: Optional[int] = None
    span: Optional[int] = None
    event_index: int = -1
    fused: Optional[Tuple] = None
    hier: Optional[Tuple] = None
    # cost-model inputs (analysis/cost.py): the dispatch-point payload
    # bytes, the algorithm the selector picked, the host span the
    # hierarchical layer annotated (None where no plan was derivable),
    # and whether the op dispatched eagerly (outside any region — the
    # MPX132 fusion critic mirrors MPX111's eager exclusion from it)
    payload_bytes: int = 0
    algo: Optional[str] = None
    hosts: Optional[int] = None
    # DCN wire codec the hierarchy applied (docs/compression.md) — the
    # cost pass prices the inter-host leg at wire bytes through it
    codec: Optional[str] = None
    eager: bool = False
    meta: Dict = field(default_factory=dict)

    def describe(self) -> str:
        if self.kind == "send":
            return f"send(dst={self.dst}, tag={self.tag})"
        if self.kind == "recv":
            src = "ANY" if self.src is None else self.src
            return f"recv(src={src}, tag={self.tag})"
        tail = f" #{self.seq}" if self.seq is not None else ""
        return f"{self.op}{tail} on comm {self.comm_uid}"


def _nelems(shape) -> Optional[int]:
    if not shape:
        return None
    n = 1
    for d in shape:
        n *= d
    return n


def build_schedule(events, rank: int, world: Optional[int] = None,
                   uid_watermark: Optional[int] = None) -> List[SchedOp]:
    """Project one rank's ordered :class:`SchedOp` schedule out of a
    recorded event stream.

    Works on both front-end shapes: a per-rank re-trace's stream (every
    event belongs to ``rank``'s program; p2p roles filter by the
    resolved routing pairs) and a single SPMD trace's stream (the same
    projection, applied once per member rank).

    ``uid_watermark`` is the comm-uid counter value captured before the
    per-rank re-traces began (analysis/crossrank.py): comms created
    BEFORE it are shared Python objects whose uid is identical in every
    rank's trace, so the uid itself is the cross-rank identity; comms
    created DURING a trace get fresh uids per re-trace and are aligned
    by creation order instead (uids are monotonic, so the j-th
    watermark-exceeding uid in one trace corresponds to the j-th in
    another).  Without a watermark every uid is treated as stable.
    """
    sched: List[SchedOp] = []
    pre: set = set()
    traced: List[int] = []
    for uid in sorted({e.comm_uid for e in events}):
        if uid_watermark is not None and uid >= uid_watermark:
            traced.append(uid)
        else:
            pre.add(uid)
    comm_keys: Dict[int, Tuple] = {uid: ("u", uid) for uid in pre}
    comm_keys.update({uid: ("t", j) for j, uid in enumerate(traced)})
    seq_counters: Dict[Tuple, int] = {}
    span_seq: Dict[int, Tuple[Tuple, int]] = {}
    # wildcard-source adoption: a recv recorded with pairs=None (the
    # reference-compatible ``recv(source=None)`` that adopts the queued
    # send's routing) pairs FIFO with the preceding send on its
    # (comm, tag) channel in the SAME stream — mirroring the region
    # queue the per-rank re-trace bypassed.  Only a recv with no
    # preceding send stays a true wildcard.
    chan_sends: Dict[Tuple, List] = {}

    def key_of(uid: int) -> Tuple:
        return comm_keys[uid]

    def participants_of(e) -> Optional[Tuple[int, ...]]:
        if e.groups is not None:
            for g in e.groups:
                if rank in g:
                    return tuple(g)
            return ()  # member of no group: not a participant
        if world is not None and e.comm_size == world:
            return tuple(range(world))
        return None  # unknown membership (sub-comm without groups info)

    # async p2p (ops/_async.py send_start/recv_start/p2p_wait): the send
    # half is buffered at issue, exactly like the blocking send; the recv
    # half ADOPTS its routing at issue position (FIFO, same channel rule
    # as above) but BLOCKS — and is therefore matched/priced — at its
    # p2p_wait position.  span -> (comm_key, tag, pairs) carries the
    # adoption from the start to the wait.
    p2p_spans: Dict[int, Optional[Tuple]] = {}

    for e in events:
        ck = key_of(e.comm_uid)
        base = dict(rank=rank, pos=len(sched), op=e.op, comm_uid=e.comm_uid,
                    comm_key=ck, dtype=e.dtype, nelems=_nelems(e.shape),
                    payload_bytes=e.payload_bytes, eager=e.eager,
                    event_index=e.index, meta=dict(e.extra))
        if e.op in ("send_start", "recv_start", "p2p_wait"):
            if e.op == "send_start":
                pairs = e.pairs
                if not e.eager:
                    chan_sends.setdefault((ck, e.tag), []).append(pairs)
                if e.span is not None:
                    p2p_spans[e.span] = None  # send side: wait is local
                if pairs:
                    for s, d in pairs:
                        if s == rank:
                            sched.append(SchedOp(kind="send", src=rank,
                                                 dst=d, tag=e.tag,
                                                 span=e.span, **base))
                            base = dict(base, pos=len(sched))
            elif e.op == "recv_start":
                pairs = e.pairs
                if not e.eager:
                    queued = chan_sends.get((ck, e.tag))
                    adopted = queued.pop(0) if queued else None
                    if pairs is None:
                        pairs = adopted
                if e.span is not None:
                    p2p_spans[e.span] = (ck, e.tag, pairs)
                # nothing blocks here: the transfer retires at the wait
            else:  # p2p_wait
                if e.span is None or e.span not in p2p_spans:
                    continue  # unpaired wait: MPX112's domain
                linked = p2p_spans.pop(e.span)
                if linked is None:
                    continue  # send-side wait never blocks on a peer
                ck2, tag, pairs = linked
                base["comm_key"] = ck2
                if pairs is None:
                    sched.append(SchedOp(kind="recv", src=None, dst=rank,
                                         tag=tag, span=e.span, **base))
                    continue
                for s, d in pairs:
                    if d == rank:
                        sched.append(SchedOp(kind="recv", src=s, dst=rank,
                                             tag=tag, span=e.span, **base))
                        base = dict(base, pos=len(sched))
            continue
        if e.op in P2P_OPS:
            pairs = e.pairs
            if e.op == "send" and not e.eager:
                chan_sends.setdefault((ck, e.tag), []).append(pairs)
            if e.op in ("send", "sendrecv") and pairs:
                for s, d in pairs:
                    if s == rank:
                        sched.append(SchedOp(kind="send", src=rank, dst=d,
                                             tag=e.tag, **base))
                        base = dict(base, pos=len(sched))
            if e.op == "recv" and not e.eager:
                queued = chan_sends.get((ck, e.tag))
                adopted = queued.pop(0) if queued else None
                if pairs is None:
                    pairs = adopted
            if e.op == "recv" and pairs is None:
                # true wildcard: source unresolved AND no preceding send
                # on the channel — matches any issued send to this
                # rank/tag at match time
                sched.append(SchedOp(kind="recv", src=None, dst=rank,
                                     tag=e.tag, **base))
                continue
            if e.op in ("recv", "sendrecv") and pairs:
                for s, d in pairs:
                    if d == rank:
                        sched.append(SchedOp(kind="recv", src=s, dst=rank,
                                             tag=e.tag, **base))
                        base = dict(base, pos=len(sched))
            continue

        parts = participants_of(e)
        if parts == ():
            continue
        fused = None
        if e.fused_members is not None:
            fused = (e.fused_members, e.fused_bytes, e.fused_layout)
        if e.op.endswith("_start"):
            seq = seq_counters.get(ck, 0)
            seq_counters[ck] = seq + 1
            if e.span is not None:
                span_seq[e.span] = (ck, seq)
            kind = "start"
        elif e.op.endswith("_wait"):
            linked = span_seq.get(e.span) if e.span is not None else None
            if linked is None:
                continue  # unpaired wait: MPX112's domain, not matchable
            ck, seq = linked
            base["comm_key"] = ck
            kind = "wait"
        else:
            seq = seq_counters.get(ck, 0)
            seq_counters[ck] = seq + 1
            kind = "coll"
        sched.append(SchedOp(kind=kind, seq=seq, participants=parts,
                             root=e.root, reduction=e.reduction,
                             span=e.span, fused=fused, hier=e.hier,
                             algo=e.algo, hosts=e.hosts,
                             codec=getattr(e, "codec", None), **base))
    return sched
