"""Elastic recovery: survive rank loss and keep training.

PyTorch counterpart of the shrink-and-resume half of
``mpi4jax_tpu/resilience/elastic.py``, shaped after MPI's User-Level
Failure Mitigation (revoke, shrink, agree) and Elastic Horovod (resume
from replicated in-memory state, not disk):

1. **Failure commit.**  A watchdog expiry (claimed by :func:`run`
   through ``watchdog.set_on_timeout``) or a peer-death error raises
   :class:`RankFailure` with the *suspected* global ranks.  The survivors
   then agree on the failed set over TCP: through rank 0 by default
   (:func:`coordinator_agreement` is the pure model,
   :func:`coordinator_exchange_suspects` the runtime form), degrading to
   gossip among the survivors when the coordinator is a suspect or
   unreachable, or under ``MPI4JAX_TPU_ELASTIC_AGREEMENT=gossip``
   (:func:`gossip_agreement` / :func:`exchange_suspects`).  Every
   survivor commits the same set.
2. **Revoke and shrink.**  :func:`advance_epoch` bumps the communication
   epoch: a comm stamped with an older one refuses every collective
   (MPX126, ``ops/_base.py:check_comm``), a pinned program refuses its
   next call (MPX129, ``aot/invalidation.py``), and the watchdog's
   in-flight entries and the resilience plan memo are dropped.  The port
   runs one process per rank, so every shrink of a world of several
   ranks is a re-bootstrap (:meth:`ShardStore.rebootstrap`): the revoked
   process group is destroyed and a fresh one initialised over the
   survivors at a ``file://`` rendezvous of its own per epoch
   (``<base>.e<epoch>``; a FileStore cannot be reused at another world
   size), survivor ranks compacted (:func:`compact_rank_map`), and the
   grid, the default grid and comm, the process groups and the send
   queues of the revoked world dropped.
3. **Resume.**  :class:`ShardStore` keeps an in-memory, sharded copy of
   the replicated training state on the host: rank ``r`` owns flat-byte
   shard ``r`` and stores the shards its placement gives it
   (:func:`stripe_placement` by default, :func:`neighbor_placement`
   under ``MPI4JAX_TPU_ELASTIC_PLACEMENT=neighbor``); the table in force
   is recorded on each commit and restores follow the recorded table.
   :func:`run` wraps the training loop: on ``RankFailure`` it agrees,
   revokes, shrinks, restores the last commit (one SUM ``allreduce`` of
   uint8 over the new comm, one contributor per shard) and continues on
   ``k - f`` ranks from the committed step.

Unblocking a stalled collective.  The JAX package tears its distributed
client down from the watchdog's thread; PyTorch cannot abort a gloo call
from another thread, so in the port a stalled collective breaks on its
process group's own ``timeout`` (``init_distributed(timeout=)``; give it
a small multiple of the watchdog's).  The claimed watchdog posts the
failure first, and :func:`classify_failure` adopts it for the error the
timeout raises.  Gloo's timeout text matches none of the JAX package's
peer-death markers, so without a claim it propagates as an ordinary
error, as there; gloo's "Connection closed by peer" classifies.

The pure half (epochs, placement, renumbering, ports, the agreement
models and their TCP runtime, failure classification, byte packing)
needs no torch; everything that moves tensors imports it lazily.

Not here yet (ROADMAP Queue 1 item 3): growing a world (the cold-join
half of ``ShardStore``, ``join_and_run``), graceful drains (``preempt``,
the SIGTERM handler, MPX127) and row/column shrinks driven end to end.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import warnings
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from ..utils import config

__all__ = [
    "RankFailure",
    "ShardStore",
    "run",
    "current_epoch",
    "advance_epoch",
    "epoch_history",
    "elastic_cache_token",
    "origin_rank",
    "compact_rank_map",
    "shrink_groups",
    "expand_fail_unit",
    "shrunken_shape",
    "replica_ranks",
    "shards_held_by",
    "neighbor_placement",
    "stripe_placement",
    "placement_shards_held_by",
    "placement_recoverable",
    "plan_from_placement",
    "recoverable",
    "reconstruction_plan",
    "shard_bounds",
    "gossip_agreement",
    "coordinator_agreement",
    "majority_survives",
    "reassemble_from_stores",
    "revoke_epoch",
    "exchange_suspects",
    "coordinator_exchange_suspects",
    "negotiate_failed",
    "classify_failure",
    "take_pending_failure",
    "coordinator_port",
    "join_port",
    "control_port",
    "agree_port",
    "rendezvous_for",
    "align_commit_every",
    "resolve_auto_commit_interval",
    "pack_leaves",
    "unpack_leaves",
]

GROW_NOT_PORTED = (
    "MPI4JAX_TPU_ELASTIC_GROW is set, but growing a world (admitting "
    "replacement ranks) is not ported yet: ROADMAP Queue 1 item 3 "
    "(grow, drain and row shrinks); unset it to run the shrink-and-resume "
    "half")


class RankFailure(RuntimeError):
    """One or more ranks are suspected dead/stalled.

    ``suspects`` are GLOBAL ranks (row-major over the comm's full axes).
    An empty suspect set means "something died but this rank cannot name
    it" (a generic distributed-runtime error): the agreement round
    resolves it from link health.
    """

    def __init__(self, suspects: Iterable[int] = (), detail: str = ""):
        self.suspects: FrozenSet[int] = frozenset(int(r) for r in suspects)
        self.detail = detail
        names = sorted(self.suspects) if self.suspects else "unknown"
        super().__init__(
            f"rank failure suspected (ranks {names})"
            + (f": {detail}" if detail else "")
        )


# ---------------------------------------------------------------------------
# communication epochs
# ---------------------------------------------------------------------------
#
# The epoch is the revocation mechanism: comms stamp the epoch they were
# built in (parallel/comm.py) and a collective on a comm of an older one
# raises MPX126 at dispatch; a pin captures it (aot/invalidation.py) and
# refuses its next call (MPX129); the resilience cache token folds it in.

_epoch_lock = threading.Lock()
_epoch = 0
# one record per epoch advance: {"epoch", "world", "cause", "detail"}
_epoch_history: List[dict] = []
# the launch world's rank of each current global rank, once a shrink
# renumbered them (None: the identity).  Fault clauses address the launch
# world's ranks (resilience/faultinject.py), so that a drill that hangs
# rank 2 does not hang the survivor renumbered 2 after the shrink.
_rank_origin: Optional[Tuple[int, ...]] = None


def current_epoch() -> int:
    """The current communication epoch (0 until the first revocation)."""
    return _epoch


def advance_epoch(*, world: Optional[int] = None, cause: str = "revoke",
                  detail: str = "") -> int:
    """Revoke the current epoch: bump the counter (every comm and pin of
    the old one is refused from now on) and the configuration epoch.
    ``world``/``cause``/``detail`` describe the boundary for
    :func:`epoch_history` (``cause`` is ``"failure"`` for a shrink,
    ``"revoke"`` for a bare revocation).  Returns the new epoch."""
    global _epoch
    with _epoch_lock:
        _epoch += 1
        new = _epoch
        _epoch_history.append({
            "epoch": new,
            "world": world,
            "cause": cause,
            "detail": detail,
        })
    config.bump_config_epoch()
    return new


def epoch_history() -> List[dict]:
    """One record per epoch advance (epoch, post-boundary world size,
    cause, detail): the audit trail of a churning run, embedded in
    postmortem bundles (``telemetry/health.py``)."""
    with _epoch_lock:
        return [dict(r) for r in _epoch_history]


def origin_rank(rank: int) -> int:
    """The launch world's rank of current global rank ``rank``."""
    origin = _rank_origin
    if origin is None or not 0 <= rank < len(origin):
        return int(rank)
    return origin[rank]


def _renumber_origin(rank_map: Dict[int, int]) -> None:
    """Compose a shrink's ``{old: new}`` rank map into the origin map."""
    global _rank_origin
    new = [0] * len(rank_map)
    for old, cur in rank_map.items():
        new[cur] = origin_rank(old)
    _rank_origin = tuple(new)


def _reset_epoch_for_tests() -> None:
    global _epoch, _rank_origin
    with _epoch_lock:
        _epoch = 0
        del _epoch_history[:]
    _rank_origin = None
    config.bump_config_epoch()


def elastic_cache_token():
    """The elastic contribution to the resilience cache token
    (``resilience/runtime.py:cache_token``): the epoch plus the declared
    elastic knobs (grow, fail unit, drain grace, port span).  With
    elastic never engaged and every knob at its default this is the
    constant 0, as in the JAX package."""
    grow = config.elastic_grow()
    unit = config.elastic_fail_unit()
    grace = config.drain_grace_s()
    span = config.elastic_port_span()
    if (not grow and unit == "rank"
            and grace == config.DEFAULT_DRAIN_GRACE_S
            and span == config.DEFAULT_ELASTIC_PORT_SPAN):
        return _epoch
    return (_epoch, grow, unit, grace, span)


# ---------------------------------------------------------------------------
# shard ownership + replica placement (pure)
#
# Two placement policies share one table shape: ``table[s]`` is the tuple
# of ranks holding shard s, owner first.
#
#   neighbor  (replica_ranks / neighbor_placement): shard s on ranks
#             s..s+redundancy mod k.  Host-blind: a whole-host loss can
#             erase every copy of a shard within the redundancy budget.
#   stripe    (stripe_placement): topology-aware; every replica lands on
#             a DIFFERENT host than the owner (and than each other, while
#             hosts allow), so any single-host loss leaves every shard a
#             live copy whenever redundancy >= 1 and hosts >= 2.
#
# The stripe is the default (MPI4JAX_TPU_ELASTIC_PLACEMENT); with no
# topology it degrades to exactly the neighbor table.
# ---------------------------------------------------------------------------


def shard_bounds(nbytes: int, k: int) -> Tuple[int, int]:
    """``(shard_size, padded_size)`` splitting ``nbytes`` into ``k`` equal
    byte shards (the last shard is zero-padded) — the same equal-chunk
    padding rule the ring reduce_scatter uses for non-divisible
    payloads."""
    if k < 1:
        raise ValueError(f"need at least one rank, got k={k}")
    shard = -(-nbytes // k) if nbytes else 0  # ceil div; 0 stays 0
    return shard, shard * k


def replica_ranks(shard: int, k: int, redundancy: int) -> Tuple[int, ...]:
    """Ranks holding a copy of ``shard``: the owner (rank == shard id)
    plus its ``redundancy`` right neighbors, mod k — so every shard has
    ``redundancy + 1`` copies on distinct ranks and ANY ``redundancy``
    simultaneous failures leave a live copy."""
    if not 0 <= shard < k:
        raise ValueError(f"shard {shard} out of range for k={k}")
    if redundancy < 0:
        raise ValueError(f"redundancy must be >= 0, got {redundancy}")
    r = min(redundancy, k - 1)  # more copies than ranks is just "everyone"
    return tuple((shard + j) % k for j in range(r + 1))


def shards_held_by(rank: int, k: int, redundancy: int) -> Tuple[int, ...]:
    """Inverse of :func:`replica_ranks`: the shards rank ``rank`` stores —
    its own plus its ``redundancy`` left neighbors', mod k."""
    if not 0 <= rank < k:
        raise ValueError(f"rank {rank} out of range for k={k}")
    r = min(max(redundancy, 0), k - 1)
    return tuple(sorted((rank - j) % k for j in range(r + 1)))


def neighbor_placement(k: int, redundancy: int) -> Tuple[Tuple[int, ...], ...]:
    """The full neighbor placement table: ``table[s] == replica_ranks(s)``.
    Kept reachable (``MPI4JAX_TPU_ELASTIC_PLACEMENT=neighbor``) as the
    drill harness's negative control — the placement a host-row kill
    provably defeats (``resilience/drill.py``)."""
    return tuple(replica_ranks(s, k, redundancy) for s in range(k))


def _host_of_rank(topology, k: int) -> Optional[Tuple[int, ...]]:
    """Normalize ``topology`` to a length-``k`` host-id tuple, or ``None``.

    Accepts an object with a ``host_of_rank`` sequence,
    a per-host rank-count sequence (``(4, 4)``), or a spec string in the
    ``MPI4JAX_TPU_TOPOLOGY`` grammar (``'2x4'`` / ``'3,5'``).  A topology
    that does not cover exactly ``k`` ranks resolves to ``None`` (the
    caller falls back to the topology-less table): placement silently
    guessing host boundaries would void the stripe guarantee."""
    if topology is None:
        return None
    hor = getattr(topology, "host_of_rank", None)
    if hor is None:
        counts = (config.parse_topology_spec(topology)
                  if isinstance(topology, str)
                  else tuple(int(c) for c in topology))
        if counts is None:
            return None
        if any(c < 1 for c in counts):
            raise ValueError(
                f"topology host counts must be positive, got {counts}")
        hor = tuple(h for h, c in enumerate(counts) for _ in range(c))
    else:
        hor = tuple(int(h) for h in hor)
    return hor if len(hor) == k else None


def stripe_placement(k: int, redundancy: int,
                     topology=None) -> Tuple[Tuple[int, ...], ...]:
    """Topology-aware replica placement: ``table[s]`` is the tuple of
    ranks holding shard ``s``, owner (rank ``s``) first.

    Candidate replicas are ordered one rank per host, hosts in
    increasing (wrapping) distance from the owner's host, the owner's
    own host strictly last; within a host the candidate local index
    wraps from the owner's local index, keeping per-host shard load
    balanced.  Consequences the tests pin:

    - every replica lands on a DIFFERENT host than the owner, and than
      the other replicas, while hosts allow (``redundancy < hosts``);
    - any SINGLE-host loss leaves every shard >= 1 live copy whenever
      ``redundancy >= 1`` and ``hosts >= 2`` (the first replica is
      always off-host) — the property neighbor placement lacks;
    - with no topology (or one host) the table degrades to exactly
      :func:`neighbor_placement`;
    - ``redundancy >= hosts`` forces replica co-location on hosts: the
      placement warns once and wraps gracefully (copies still land on
      distinct ranks while ``k`` allows — the extra copies buy rank-loss
      budget, not host-loss budget).
    """
    if k < 1:
        raise ValueError(f"need at least one rank, got k={k}")
    if redundancy < 0:
        raise ValueError(f"redundancy must be >= 0, got {redundancy}")
    r = min(redundancy, k - 1)
    hor = _host_of_rank(topology, k)
    if hor is None:
        return neighbor_placement(k, redundancy)
    members: Dict[int, List[int]] = {}
    for rank, h in enumerate(hor):
        members.setdefault(h, []).append(rank)
    order = sorted(members)
    hosts = len(order)
    hidx = {h: i for i, h in enumerate(order)}
    lidx = {}
    for ranks in members.values():
        for i, rank in enumerate(ranks):
            lidx[rank] = i
    if hosts > 1 and r >= hosts:
        warnings.warn(
            f"stripe_placement: redundancy {redundancy} >= hosts {hosts}: "
            "replica copies must co-locate on hosts (a single-host loss "
            "stays recoverable; the extra copies only add rank-loss "
            "budget) — wrapping the stripe around the hosts",
            RuntimeWarning, stacklevel=2)
    table = []
    for s in range(k):
        h = hidx[hor[s]]
        l = lidx[s]
        cands = []
        for c in range(k):
            if c == s:
                continue
            ch = hidx[hor[c]]
            d = (ch - h) % hosts
            q = (lidx[c] - l) % len(members[order[ch]])
            # one rank per host per wrap q, hosts in distance order,
            # the owner's own host (d == 0) strictly after every other
            cands.append(((1, q, 0) if d == 0 else (0, q, d), c))
        cands.sort()
        table.append((s,) + tuple(c for _, c in cands[:r]))
    return tuple(table)


def placement_shards_held_by(rank: int, placement) -> Tuple[int, ...]:
    """Inverse of a placement table: the shards ``rank`` holds."""
    return tuple(sorted(s for s, holders in enumerate(placement)
                        if rank in holders))


def placement_recoverable(failed: Iterable[int], placement) -> bool:
    """True iff every shard keeps >= 1 surviving copy under ``placement``
    after losing ``failed``."""
    dead = frozenset(failed)
    return all(any(r not in dead for r in holders)
               for holders in placement)


def plan_from_placement(failed: Iterable[int], placement) -> Dict[int, int]:
    """``{shard: provider}`` over an arbitrary placement table: for EVERY
    shard, the lowest-numbered surviving holder — the deterministic
    choice every survivor computes independently from the same committed
    table, so the restore exchange has exactly one contributor per
    shard.  Raises ``RankFailure`` when a shard lost every copy."""
    dead = frozenset(failed)
    plan = {}
    for s, holders in enumerate(placement):
        live = [r for r in holders if r not in dead]
        if not live:
            raise RankFailure(
                dead,
                f"shard {s} unrecoverable: all {len(holders)} replica "
                f"ranks {tuple(holders)} failed (the placement tolerates "
                f"at most {len(holders) - 1} simultaneous losses of a "
                "shard's holders)",
            )
        plan[s] = min(live)
    return plan


def recoverable(failed: Iterable[int], k: int, redundancy: int,
                placement=None) -> bool:
    """True iff every shard still has at least one surviving copy after
    losing ``failed`` — i.e. no shard's whole replica set died.
    ``placement`` defaults to the neighbor table (back-compat); pass a
    :func:`stripe_placement` table to judge the striped layout."""
    table = (neighbor_placement(k, redundancy)
             if placement is None else placement)
    return placement_recoverable(failed, table)


def reconstruction_plan(
    failed: Iterable[int], k: int, redundancy: int, placement=None
) -> Dict[int, int]:
    """``{shard: provider}`` naming, for EVERY shard, the lowest-numbered
    surviving rank holding a copy (:func:`plan_from_placement`).  Raises
    ``RankFailure`` when a shard lost all its copies (more simultaneous
    failures than the placement tolerates).  ``placement`` defaults to
    the neighbor table; the runtime passes the table recorded on the
    commit, so restore always follows the placement the bytes actually
    landed under."""
    table = (neighbor_placement(k, redundancy)
             if placement is None else placement)
    if len(table) != k:
        raise ValueError(
            f"placement table covers {len(table)} shards, expected {k}")
    return plan_from_placement(failed, table)


# ---------------------------------------------------------------------------
# rank compaction + group shrink (pure)
# ---------------------------------------------------------------------------


def compact_rank_map(world: int, failed: Iterable[int]) -> Dict[int, int]:
    """``{old_global_rank: new_global_rank}`` for the survivors, compacted
    in ascending old-rank order (survivor i becomes new rank i) — the
    rank renumbering ULFM's ``MPI_Comm_shrink`` specifies."""
    dead = frozenset(failed)
    bad = [r for r in dead if not 0 <= r < world]
    if bad:
        raise ValueError(f"failed ranks {sorted(bad)} out of range for "
                         f"world {world}")
    if len(dead) >= world:
        raise RankFailure(dead, "no survivors: every rank failed")
    survivors = [r for r in range(world) if r not in dead]
    return {old: new for new, old in enumerate(survivors)}


def shrink_groups(groups, failed: Iterable[int], world: int):
    """Rebuild a color-split comm's group tables as "all minus failed":
    drop the failed ranks, renumber survivors via :func:`compact_rank_map`
    (preserving each group's order), drop groups that lost every member.
    Returns the new group tuple in the new (compacted) rank space.

    Generalizes unchanged to the 2-D renumbering: a Cartesian row/column
    shrink passes the *expanded* failed set (:func:`expand_fail_unit`),
    and because whole rows/columns are removed the row-major compaction
    IS the new grid's row-major numbering."""
    rmap = compact_rank_map(world, failed)
    out = []
    for members in groups:
        kept = tuple(rmap[r] for r in members if r in rmap)
        if kept:
            out.append(kept)
    return tuple(out)


def expand_fail_unit(failed: Iterable[int], shape, fail_unit: str):
    """Expand a failed-rank set to the declared shrink granularity.

    ``shape`` is the mesh's dimension tuple (row-major rank order);
    ``fail_unit`` is ``"rank"`` / ``"row"`` / ``"col"``
    (``MPI4JAX_TPU_ELASTIC_FAIL_UNIT``).  ``"row"`` returns every rank
    sharing a first-axis index with a failed rank, ``"col"`` every rank
    sharing a second-axis index — the whole-grid-line removal that keeps
    a Cartesian mesh rectangular.  On a 1-D mesh a row is a rank, so
    every unit degrades to ``"rank"``.  Pure: the renumbering
    tests drive it directly."""
    shape = tuple(int(n) for n in shape)
    world = 1
    for n in shape:
        world *= n
    failed = frozenset(int(r) for r in failed)
    bad = [r for r in failed if not 0 <= r < world]
    if bad:
        raise ValueError(
            f"failed ranks {sorted(bad)} out of range for world {world}")
    if fail_unit not in ("rank", "row", "col"):
        raise ValueError(
            f"fail_unit must be 'rank', 'row', or 'col', got {fail_unit!r}")
    if fail_unit == "rank" or len(shape) == 1 or not failed:
        return failed
    if len(shape) != 2:
        raise ValueError(
            f"fail_unit={fail_unit!r} supports 1-D and 2-D meshes, got "
            f"shape {shape}"
        )
    rows, cols = shape
    if fail_unit == "row":
        dead_rows = {r // cols for r in failed}
        return frozenset(
            i * cols + j for i in dead_rows for j in range(cols))
    dead_cols = {r % cols for r in failed}
    return frozenset(
        i * cols + j for i in range(rows) for j in dead_cols)


def shrunken_shape(shape, expanded_failed: Iterable[int], fail_unit: str):
    """The mesh shape after removing ``expanded_failed`` (an
    :func:`expand_fail_unit` result) at ``fail_unit`` granularity —
    whole rows/columns drop off the matching dimension; rank-unit
    removal flattens a 1-D shape."""
    shape = tuple(int(n) for n in shape)
    dead = frozenset(int(r) for r in expanded_failed)
    if len(shape) == 1 or fail_unit == "rank":
        world = 1
        for n in shape:
            world *= n
        return (world - len(dead),)
    rows, cols = shape
    if fail_unit == "row":
        dead_rows = {r // cols for r in dead}
        return (rows - len(dead_rows), cols)
    dead_cols = {r % cols for r in dead}
    return (rows, cols - len(dead_cols))


# ---------------------------------------------------------------------------
# per-epoch rendezvous ports (pure math)
# ---------------------------------------------------------------------------
#
# Every elastic rendezvous derives its port from the epoch so revoked-world
# sockets can never collide with the recovered world's — but the naive
# ``port_base + epoch`` walks out of the ephemeral range after enough
# churn.  All port derivation therefore wraps within a declared window of
# ``span`` ports (``MPI4JAX_TPU_ELASTIC_PORT_SPAN``):
#
#   [port_base,          port_base +   span)   the coordinator window
#   [port_base +   span, port_base + 2*span)   join listener (rank 0)
#   [port_base + 2*span, port_base + 4*span)   per-rank control listeners
#                                              (two alternating epoch banks,
#                                              so consecutive epochs never
#                                              contend for a port)
#   [port_base + 4*span, port_base + 5*span)   agreement listener (rank 0):
#                                              the coordinator-mediated
#                                              suspect-report star
#
# A wrap collision (epoch e vs e+span) lands on a socket the revoked world
# closed span epochs ago; the residual TIME_WAIT case is absorbed by the
# bootstrap retry policy that already wraps every bind/connect.  The port
# rendezvouses its process groups at files (rendezvous_for), so of these
# it binds the agreement star's port and the gossip ports above
# ``agree_port_base``; the rest is the JAX package's arithmetic, kept.


def wrapped_epoch(epoch: int, span: Optional[int] = None) -> int:
    """``epoch % span`` with the span from the declared flag."""
    span = config.elastic_port_span() if span is None else int(span)
    if span < 1:
        raise ValueError(f"port span must be >= 1, got {span}")
    return int(epoch) % span


def coordinator_port(port_base: int, epoch: int,
                     span: Optional[int] = None) -> int:
    """The distributed coordinator port for ``epoch`` — what a
    replacement process contacts (``port_base + epoch``, wrapped within
    the declared window)."""
    return int(port_base) + wrapped_epoch(epoch, span)


def join_port(port_base: int, epoch: int, span: Optional[int] = None) -> int:
    """The coordinator's join-listener port for ``epoch`` (its own
    span-wide bank above the coordinator window, so a joiner can scan
    the whole window without ever poking a coordinator socket)."""
    span = config.elastic_port_span() if span is None else int(span)
    return int(port_base) + span + wrapped_epoch(epoch, span)


def control_port(port_base: int, rank: int, epoch: int,
                 span: Optional[int] = None) -> int:
    """Rank ``rank``'s control-listener port in ``epoch`` (drain notices
    and acks).  Two alternating epoch banks: epoch e and e+1 use
    disjoint ports, so a process rebinding after a shrink can never race
    the previous world's listener for the same port."""
    span = config.elastic_port_span() if span is None else int(span)
    if not 0 <= int(rank) < span:
        raise ValueError(
            f"control_port: rank {rank} outside the span window {span} "
            "(raise MPI4JAX_TPU_ELASTIC_PORT_SPAN above the world size)")
    bank = int(epoch) % 2
    return int(port_base) + 2 * span + bank * span + int(rank)


def agree_port(port_base: int, epoch: int, span: Optional[int] = None) -> int:
    """The coordinator's agreement-listener port for ``epoch`` — where
    survivors report their suspect sets in the coordinator-mediated
    agreement (its own span-wide bank above the control windows, so a
    report can never poke a coordinator or control socket)."""
    span = config.elastic_port_span() if span is None else int(span)
    return int(port_base) + 4 * span + wrapped_epoch(epoch, span)



# ---------------------------------------------------------------------------
# failure agreement (pure model + TCP runtime form)
# ---------------------------------------------------------------------------


def gossip_agreement(
    suspects: Dict[int, Iterable[int]],
    links,
) -> Dict[int, FrozenSet[int]]:
    """The agreement round, as a pure fixpoint over a link matrix.

    ``suspects[r]`` is rank r's locally-observed suspect set;
    ``links[i][j]`` is True when the i↔j link is healthy (symmetric;
    the diagonal is ignored).  Each round every rank unions the suspect
    sets of the peers it can reach over healthy links, and additionally
    suspects any peer it has NO healthy link to; rounds repeat to
    fixpoint (≤ world rounds — each round only grows sets).

    Within one connected component of the healthy-survivor subgraph the
    result is identical on every member — the agreement property the
    runtime form inherits.  Disconnected components can disagree; that is
    the split-brain case :func:`majority_survives` arbitrates.

    Gossip is read over EVERY healthy link, including from a peer already
    in the reader's suspect set — matching the runtime form, whose inbox
    unions every message that lands regardless of the reader's current
    suspicion.  (An earlier revision skipped suspected peers' gossip,
    which made convergence order-dependent: a rank could hearsay-suspect
    a live peer mid-round and then permanently miss a suspect known only
    to that peer — the "something died but unnamed" case under a
    partitioned link matrix, where the only name-carrier may itself be
    partition-suspected.)  Suspect values outside ``range(world)`` raise
    ``ValueError`` — a stale-numbering suspect silently joining the
    fixpoint would poison every survivor's verdict.
    """
    world = len(links)
    for r, named in suspects.items():
        bad = sorted(int(p) for p in named if not 0 <= int(p) < world)
        if bad:
            raise ValueError(
                f"gossip_agreement: rank {r} names suspects {bad} outside "
                f"the world of {world} ranks (stale numbering?)")
    # every rank computes (a dead rank's output is simply ignored by its
    # peers — they have no healthy link to read it over)
    agreed = {r: set(map(int, suspects.get(r, ()))) for r in range(world)}
    changed = True
    rounds = 0
    while changed and rounds <= world + 1:
        changed = False
        rounds += 1
        snapshot = {r: frozenset(s) for r, s in agreed.items()}
        for r in range(world):
            mine = agreed[r]
            before = len(mine)
            for p in range(world):
                if p == r:
                    continue
                healthy = links[r][p] and links[p][r]
                if not healthy:
                    mine.add(p)          # unreachable peer => suspect
                else:
                    mine |= snapshot[p]  # gossip over the healthy link
            if len(mine) != before:
                changed = True
    return {r: frozenset(s) for r, s in agreed.items()}


def coordinator_agreement(
    suspects: Dict[int, Iterable[int]],
    links,
    coordinator: int = 0,
) -> Dict[int, FrozenSet[int]]:
    """Pure model of the coordinator-mediated agreement round — the O(k)
    star that replaces the O(k²) all-pairs gossip at pod scale.

    Every rank's effective REPORT is its local suspect set plus every
    peer it has no healthy link to (the same link-derived suspicion
    :func:`gossip_agreement` applies).  Ranks with a healthy link to
    ``coordinator`` that do not locally name it a suspect form the star:
    each sends one report, the coordinator unions them (its own
    included), adds every rank that never reported, and rebroadcasts one
    verdict — 2 messages over k-1 connections.  Ranks outside the star
    degrade to peer gossip among themselves; the star ranks are parked
    at the coordinator and answer no gossip, so the degraded matrix
    masks them out (an isolated degraded rank therefore suspects
    everyone and aborts on the majority guard — conservative, never
    split-brained).

    Arbiter property (pinned by the tests): whenever the coordinator has
    a healthy link to every live rank, the star verdict equals
    :func:`gossip_agreement`'s fixpoint on the same inputs — the star is
    a 1-hop spanning tree of the survivor component and both compute the
    component-wide union.  A dead (or universally-suspected) coordinator
    degrades EVERY survivor, and the result is exactly the gossip
    fixpoint — so the pure gossip model stays the arbiter the runtime
    transport must converge to in every case.
    """
    world = len(links)

    def healthy(a: int, b: int) -> bool:
        return bool(links[a][b] and links[b][a])

    local = {r: set(map(int, suspects.get(r, ()))) for r in range(world)}
    reports = {
        r: local[r] | {p for p in range(world)
                       if p != r and not healthy(r, p)}
        for r in range(world)
    }
    star = [r for r in range(world)
            if r == coordinator
            or (healthy(r, coordinator) and coordinator not in local[r])]
    verdict: set = set()
    for r in star:
        verdict |= reports[r]
    # a rank that never reports is suspected (it is either dead — already
    # in the coordinator's own link-derived report — or degraded to
    # gossip the star cannot hear)
    verdict |= set(range(world)) - set(star)
    out = {r: frozenset(verdict) for r in star}
    rest = [r for r in range(world) if r not in star]
    if rest:
        keep = set(rest)
        masked = [[bool(links[i][j]) and i in keep and j in keep
                   for j in range(world)] for i in range(world)]
        fallen = gossip_agreement(suspects, masked)
        for r in rest:
            out[r] = fallen[r]
    return out


def majority_survives(agreed_failed: Iterable[int], world: int) -> bool:
    """Split-brain guard: a survivor partition keeps running only when it
    holds a strict majority of the original world (otherwise two halves
    of a partitioned job would both shrink and train divergent models).
    """
    survivors = world - len(frozenset(agreed_failed))
    return survivors * 2 > world


def _recv_all(conn, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def exchange_suspects(
    my_rank: int,
    world: int,
    suspects: Iterable[int],
    host: str,
    port_base: int,
    *,
    rounds: int = 2,
    timeout: float = 20.0,
) -> FrozenSet[int]:
    """The runtime agreement: gossip suspect sets over TCP among the
    survivors (rank r listens on ``port_base + r``).

    Two rounds by default: round 1 unions everyone's locally-observed
    suspects (a peer that cannot be reached joins the set), round 2
    propagates the unions so survivors that observed different symptoms
    converge — the TCP realization of :func:`gossip_agreement` on a
    connected survivor component.  Small-world only (the drill scale);
    pod-scale deployments would run this over the coordinator.
    """
    agreed = set(int(r) for r in suspects)
    agreed.discard(my_rank)

    inbox: List[FrozenSet[int]] = []
    heard: set = set()   # peers we have EVIDENCE are alive (they sent to us)
    lock = threading.Lock()
    stop = threading.Event()

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port_base + my_rank))
    srv.listen(world)
    srv.settimeout(0.2)

    def _serve():
        try:
            while not stop.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                with conn:
                    try:
                        conn.settimeout(timeout)
                        header = _recv_all(conn, 8)
                        if len(header) < 8:
                            continue
                        n = int.from_bytes(header, "big")
                        payload = json.loads(_recv_all(conn, n).decode())
                        with lock:
                            heard.add(int(payload["from"]))
                            inbox.append(frozenset(
                                int(r) for r in payload["suspects"]))
                    except (OSError, ValueError, KeyError, TypeError):
                        continue
        finally:
            srv.close()

    def _send_with_patience(peer: int, msg: bytes) -> bool:
        """Deliver to a peer, retrying refusals until ``timeout``: the
        survivors reach the agreement phase at different times (failure
        detection is not synchronized), so an instant connection-refused
        from a healthy-but-late peer must not get it declared dead.  A
        peer that stays unreachable for the whole window — and never sent
        us anything either — is suspected."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                with socket.create_connection(
                    (host, port_base + peer),
                    timeout=max(0.1, deadline - time.monotonic()),
                ) as c:
                    c.sendall(len(msg).to_bytes(8, "big") + msg)
                return True
            except OSError:
                with lock:
                    if peer in heard:
                        # alive but done serving (it finished its rounds
                        # before us): not a failure, just asymmetry
                        return True
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.1)

    server = threading.Thread(target=_serve, daemon=True)
    server.start()
    try:
        for rnd in range(max(1, rounds)):
            # never gossip ourselves as a suspect (we are demonstrably
            # alive and sending) — but KEEP my_rank in the returned set
            # when peers put it there: a rank its peers declared failed
            # must see itself in the result and abort (the agreement's
            # step 1), not silently strip the verdict
            msg = json.dumps(
                {"from": my_rank,
                 "suspects": sorted(agreed - {my_rank})}).encode()
            for peer in range(world):
                if peer == my_rank or peer in agreed:
                    continue
                if not _send_with_patience(peer, msg):
                    agreed.add(peer)  # unreachable survivor => suspect
            # let the peers' sends for this round land before folding
            # (their rounds are not synchronized with ours)
            if rnd == max(1, rounds) - 1:
                time.sleep(0.5)
            with lock:
                got, inbox[:] = list(inbox), []
            for s in got:
                agreed |= set(s)
    finally:
        # linger: keep answering slow peers so OUR early exit does not get
        # us suspected (the server thread closes the socket after stop);
        # daemon so a finished worker's interpreter never waits on it
        linger = threading.Timer(timeout, stop.set)
        linger.daemon = True
        linger.start()
    return frozenset(agreed)


def coordinator_exchange_suspects(
    my_rank: int,
    world: int,
    suspects: Iterable[int],
    host: str,
    port: int,
    *,
    coordinator: int = 0,
    timeout: float = 20.0,
) -> FrozenSet[int]:
    """Runtime form of :func:`coordinator_agreement`'s star: O(k)
    connections instead of the all-pairs gossip's O(k²).

    The coordinator (rank ``coordinator`` of the CURRENT world, normally
    0) binds ``port`` (:func:`agree_port`), collects one suspect report
    per survivor, unions them with its own, adds every rank that never
    reported within ``timeout``, and answers each parked connection with
    the verdict — one connection per non-coordinator survivor, the
    verdict riding the report's socket back.  Reporters dial with
    full-jitter backoff (:mod:`.retry` — the reconnection-stampede cure:
    k-1 survivors hit one listener at once) until the report lands or
    ``timeout`` elapses.

    Raises ``RuntimeError``/``OSError`` when the round cannot complete
    (coordinator unreachable, bind lost, malformed verdict) — the caller
    (:func:`negotiate_failed`) degrades to :func:`exchange_suspects`
    peer gossip, the documented fallback when the coordinator itself is
    the casualty.  Like the gossip form, ``my_rank`` is never gossiped
    by itself but is KEPT in the returned verdict when peers put it
    there — a rank its peers declared failed must see the verdict and
    abort, not silently strip it.
    """
    mine = set(int(r) for r in suspects)
    mine.discard(my_rank)

    if my_rank != coordinator:
        from .retry import retry_with_backoff

        deadline = time.monotonic() + timeout

        def _report():
            budget = max(0.1, deadline - time.monotonic())
            with socket.create_connection((host, port),
                                          timeout=budget) as c:
                # once connected the coordinator is known alive; the
                # verdict waits on ITS collection window, which may have
                # opened up to a full window after ours — grant the recv
                # that extra patience so detection skew between survivors
                # costs latency, never a spurious fallback
                c.settimeout(max(0.1, deadline - time.monotonic())
                             + timeout)
                _send_json(c, {"from": my_rank,
                               "suspects": sorted(mine)})
                reply = _recv_json(c)
                return frozenset(
                    int(r) for r in reply["verdict"]) | mine

        return retry_with_backoff(
            _report,
            what=f"suspect report to agreement coordinator "
                 f"{host}:{port}",
            deadline=timeout,
            base_delay=0.05,
            max_delay=1.0,
        )

    # --- coordinator side: collect, union, rebroadcast ---
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(world)
    srv.settimeout(0.2)
    reports: Dict[int, FrozenSet[int]] = {my_rank: frozenset(mine)}
    parked = []
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            union = set().union(*reports.values())
            # stop waiting once every rank not already suspected (by
            # anyone) has reported; suspected ranks cost no deadline
            if not (set(range(world)) - set(reports) - union):
                break
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            try:
                conn.settimeout(max(0.1, deadline - time.monotonic()))
                payload = _recv_json(conn)
                sender = int(payload["from"])
                reports[sender] = frozenset(
                    int(r) for r in payload.get("suspects", ()))
                parked.append((sender, conn))
            except (OSError, ValueError, KeyError, TypeError):
                conn.close()
        # NOT discarding my_rank: if a report named the (serving)
        # coordinator, every reporter gets a verdict containing it, so
        # the coordinator must judge itself by the same verdict —
        # stripping it locally would hand the survivors divergent sets
        verdict = set().union(*reports.values())
        verdict |= set(range(world)) - set(reports)  # non-reporters
        _meter("elastic.agreement_reports", len(parked))
        for _, conn in parked:
            try:
                _send_json(conn, {"verdict": sorted(verdict)})
            except OSError:
                pass
            finally:
                conn.close()
    finally:
        srv.close()
    return frozenset(verdict)


def negotiate_failed(
    my_rank: int,
    world: int,
    suspects: Iterable[int],
    host: str,
    *,
    agree_port_no: int,
    gossip_port_base: int,
    timeout: float = 20.0,
    mode: Optional[str] = None,
    coordinator: int = 0,
) -> FrozenSet[int]:
    """The runtime agreement entry ``_recover`` uses: coordinator star
    first (O(k) connections), degradation to all-pairs peer gossip when
    the coordinator is locally a suspect, unreachable, or the declared
    mode (``MPI4JAX_TPU_ELASTIC_AGREEMENT``) forces gossip.

    The coordinator phase gets at most HALF the agreement window: a
    survivor that needed the fallback still reaches the gossip ports
    well inside its peers' full-window send patience, so a dead
    coordinator costs latency, never a spurious suspicion."""
    mine = set(int(r) for r in suspects)
    mode = config.elastic_agreement() if mode is None else mode
    if mode == "coordinator" and coordinator not in mine:
        try:
            return coordinator_exchange_suspects(
                my_rank, world, mine, host, agree_port_no,
                coordinator=coordinator,
                timeout=max(0.2, timeout / 2.0),
            )
        except (OSError, RuntimeError):
            _meter("elastic.agreement_fallbacks")
    elif mode == "coordinator":
        _meter("elastic.agreement_fallbacks")
    return exchange_suspects(
        my_rank, world, mine, host, gossip_port_base, timeout=timeout)


# ---------------------------------------------------------------------------
# watchdog claim: expiry -> pending RankFailure instead of process death
# ---------------------------------------------------------------------------

_pending_lock = threading.Lock()
_pending_failure: Optional[RankFailure] = None


def _post_failure(rf: RankFailure) -> None:
    global _pending_failure
    with _pending_lock:
        if _pending_failure is None:
            _pending_failure = rf


def take_pending_failure() -> Optional[RankFailure]:
    """Pop the failure posted by the claimed watchdog handler (or a peer
    death notification), if any."""
    global _pending_failure
    with _pending_lock:
        rf, _pending_failure = _pending_failure, None
    return rf

def _send_json(conn, payload: dict) -> None:
    msg = json.dumps(payload).encode()
    conn.sendall(len(msg).to_bytes(8, "big") + msg)


def _recv_json(conn) -> dict:
    header = _recv_all(conn, 8)
    if len(header) < 8:
        raise OSError("connection closed before header")
    n = int.from_bytes(header, "big")
    return json.loads(_recv_all(conn, n).decode())




class _Interrupt:
    """The main thread's interrupt for a claimed expiry.  ``run`` installs
    a SIGINT handler (main thread only) that raises ``KeyboardInterrupt``
    only while the main thread is inside the step: a step that waits in
    Python (a sleep, a poll) then breaks out at once, and the recovery
    adopts the posted failure.  A main thread blocked in a gloo call takes
    the interrupt only when the call returns, on its timeout; arriving
    after the step, the interrupt is dropped, never raised in the middle
    of the recovery."""

    installed = False
    in_step = False
    requested = False
    prev = None


def _on_sigint(signum, frame):
    if _Interrupt.requested:
        _Interrupt.requested = False
        if _Interrupt.in_step:
            raise KeyboardInterrupt(
                "elastic: a claimed watchdog expiry interrupted the step")
        return
    prev = _Interrupt.prev
    if callable(prev):
        return prev(signum, frame)
    import signal as _signal

    if prev == _signal.SIG_IGN:
        return None
    raise KeyboardInterrupt


def _install_interrupt():
    """Install ``_on_sigint``; ``False`` where no handler can be
    installed (not the main thread), and then nothing is interrupted."""
    import signal as _signal

    try:
        prev = _signal.signal(_signal.SIGINT, _on_sigint)
    except (ValueError, OSError):
        return False
    _Interrupt.prev = prev
    _Interrupt.installed = True
    _Interrupt.requested = _Interrupt.in_step = False
    return True


def _uninstall_interrupt() -> None:
    import signal as _signal

    if not _Interrupt.installed:
        return
    _Interrupt.installed = False
    _Interrupt.requested = False
    try:
        prev = _Interrupt.prev
        _signal.signal(_signal.SIGINT, _signal.default_int_handler
                       if prev is None else prev)
    except (ValueError, OSError):
        pass
    _Interrupt.prev = None


def _claimed_on_timeout(entries, expired) -> None:
    """The elastic watchdog handler (installed by :func:`run` through
    ``watchdog.set_on_timeout``): instead of killing the process, post a
    pending :class:`RankFailure` (suspects unknown: this rank only knows
    its own collective stalled; the agreement round names the dead) and
    interrupt a main thread that waits in Python (``_Interrupt``).  A
    stalled gloo call breaks on its process group's timeout.

    The expiry was already journalled as a telemetry incident by the
    monitor before this handler ran (resilience/watchdog.py).
    """
    _meter("elastic.watchdog_claims")
    _post_failure(RankFailure(
        (),
        f"watchdog expiry: {expired['opname']} exceeded "
        f"{expired['timeout']:g}s (call {expired['call_id']})",
    ))
    _abort_inflight()


def _abort_inflight() -> None:
    """Best-effort unblock of the main thread: ``interrupt_main`` through
    ``run``'s SIGINT handler (see ``_Interrupt``), where it is installed."""
    if not _Interrupt.installed:
        return
    _Interrupt.requested = True
    try:
        import _thread

        _thread.interrupt_main()
    except Exception:
        pass


_FAILURE_MARKERS = (
    "deadline", "heartbeat", "connection", "unavailable", "shut down",
    "shutdown", "peer", "socket closed", "cancelled", "aborted",
    "barrier timed out", "preempt",
)


def classify_failure(exc: BaseException) -> Optional[RankFailure]:
    """Map an exception escaping the training step to a
    :class:`RankFailure`, or ``None`` when it is an ordinary error that
    must propagate.  Three sources:

    - an explicit :class:`RankFailure` (simulated drills, the health
      plane's suspects) passes through;
    - a pending failure posted by the claimed watchdog handler adopts
      the interrupting exception (``KeyboardInterrupt`` from the
      interrupt, or the error the stalled call's timeout raised);
    - a distributed-runtime death rattle (connection/peer/shutdown
      wording, gloo's "Connection closed by peer") with no pending claim
      becomes an unknown-suspect failure.
    """
    if isinstance(exc, RankFailure):
        pending = take_pending_failure()
        if pending is not None and pending.suspects - exc.suspects:
            return RankFailure(exc.suspects | pending.suspects, exc.detail)
        return exc
    pending = take_pending_failure()
    if pending is not None:
        return pending
    if isinstance(exc, (RuntimeError, OSError)):
        text = str(exc).lower()
        if any(m in text for m in _FAILURE_MARKERS):
            return RankFailure((), f"{type(exc).__name__}: {exc}")
    return None


# ---------------------------------------------------------------------------
# state packing
# ---------------------------------------------------------------------------


def _flatten_state(state):
    """``(leaves, unflatten)`` in the JAX package's leaf order (dicts by
    sorted key, ``utils/tree.py``)."""
    from ..utils.tree import tree_flatten

    return tree_flatten(state)


# numpy has no bfloat16 or float8: such tensors are packed through an
# integer view of their width
_INT_OF_WIDTH = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


def _to_host(leaf):
    """``(numpy array, torch dtype or None)`` of one leaf: a tensor is
    copied to the host once (``.cpu()``), anything else goes through
    ``np.asarray``."""
    import numpy as np
    import torch

    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    host = leaf.detach().cpu()
    try:
        return host.numpy(), leaf.dtype
    except TypeError:
        wide = getattr(torch, _INT_OF_WIDTH[host.element_size()])
        return host.contiguous().view(wide).numpy(), leaf.dtype


def _from_host(arr, dtype, device):
    """Inverse of ``_to_host``: a tensor on ``device`` (a copy of the
    bytes) for a leaf that was a tensor, else the array."""
    if dtype is None:
        return arr
    import numpy as np
    import torch

    t = torch.from_numpy(np.array(arr))
    if t.dtype != dtype:
        t = t.view(dtype)
    return t.to(device) if device is not None else t


def pack_leaves(leaves):
    """``(buffer, meta)``: concatenate the leaves' raw bytes into one
    uint8 vector (the flat unit the byte shards slice), recording
    ``(shape, dtype, nbytes)`` per leaf for :func:`unpack_leaves`."""
    import numpy as np

    arrays = [np.asarray(a) for a in leaves]
    meta = [(a.shape, a.dtype.str, a.nbytes) for a in arrays]
    if arrays:
        # tobytes (C order) rather than a uint8 view: views reject 0-d
        # arrays (scalar leaves — loss scales, step counters) and
        # non-contiguous layouts; the copy is once per commit
        buf = np.concatenate(
            [np.frombuffer(a.tobytes(), np.uint8) for a in arrays])
    else:
        buf = np.zeros((0,), np.uint8)
    return buf, meta


def unpack_leaves(buf, meta):
    import numpy as np

    out = []
    off = 0
    for shape, dtype, nbytes in meta:
        chunk = np.asarray(buf[off:off + nbytes], np.uint8)
        out.append(chunk.view(np.dtype(dtype)).reshape(shape))
        off += nbytes
    return out


def _rebuild(rec: dict, buf, device):
    """The committed state from the full flat buffer ``buf``."""
    total = sum(m[2] for m in rec["meta"])
    leaves = unpack_leaves(buf[:total], rec["meta"])
    leaves = [_from_host(a, dt, device) for a, dt in zip(leaves, rec["dtypes"])]
    return rec["unflatten"](leaves)


# ---------------------------------------------------------------------------
# telemetry glue
# ---------------------------------------------------------------------------


def _meter(name: str, n: int = 1) -> None:
    from ..telemetry import core as _tcore

    _tcore.meter(name, n)


def _incident(meter: str, name: str, rank: int, detail: str) -> None:
    from ..telemetry import journal

    journal.incident(meter, name, rank, detail)


def _health_boundary(store, step: int, committed: bool) -> None:
    """Health-detector tick at a run-loop step boundary
    (``telemetry/health.py``): the local slowdown check and the
    cross-rank digest exchange over the store's comm.  A RankFailure
    raised by the suspect hand-off (``MPI4JAX_TPU_HEALTH_SUSPECTS``) must
    PROPAGATE: it is how a persistent straggler enters the classify ->
    agree -> shrink path; anything else from the observer is
    swallowed."""
    from ..telemetry import health as _health

    try:
        _health.on_boundary(step, comm=store.comm, committed=committed)
    except RankFailure:
        raise
    except Exception:
        _meter("health.boundary_errors")


def _health_failure(rf) -> None:
    """Postmortem bundle the moment an exception classifies as a rank
    failure, before recovery changes any state."""
    from ..telemetry import health as _health

    try:
        _health.on_failure_classified(rf)
    except Exception:
        pass


def _health_rank_failed(failed, rf) -> None:
    """Symmetric post-agreement verdict: every survivor journals one
    ``health`` incident naming each agreed-failed rank."""
    from ..telemetry import health as _health

    try:
        _health.on_rank_failed(failed, getattr(rf, "detail", "") or "")
    except Exception:
        pass


# ---------------------------------------------------------------------------
# the revoked world's transport and caches
# ---------------------------------------------------------------------------


def rendezvous_for(base: str, epoch: int) -> str:
    """The ``init_method`` of ``epoch``'s process group: ``<base>.e<epoch>``
    (a ``file://`` base; a FileStore cannot be reused at another world
    size, so every epoch rendezvouses at a file of its own)."""
    return f"{base}.e{int(epoch)}"


def _teardown_process_group() -> None:
    """Destroy this process's process group (a revoked world's), if any.
    Its peers still blocked in a collective with this rank see their
    connections close and fail at once instead of at their timeout."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:
            pass


def _drop_world() -> None:
    """Forget everything the revoked world built, so that none of it is
    reused: the grid's device and process groups (``group_of`` keys
    groups by member set, so a stale group of the same members could come
    back), the default grid and comm, the resilience plan memo and pin
    counters (``ops/_base.clear_caches``) and the send queues."""
    from ..ops import _base
    from ..ops.send import drop_revoked
    from ..parallel.mesh import forget_world

    forget_world()
    _base.clear_caches()
    drop_revoked()


# ---------------------------------------------------------------------------
# ShardStore
# ---------------------------------------------------------------------------


class ShardStore:
    """In-memory sharded checkpoint of replicated state with k-redundant,
    topology-striped replication.

    Each committed state (a nest of dicts, lists and tuples of tensors or
    arrays, identical on every rank: the data-parallel contract) is
    copied to the host, flattened to one flat byte buffer, split into
    ``k`` equal byte shards (shard ``s`` owned by rank ``s``), and this
    rank stores the shards its placement table gives it: every shard lives
    on ``redundancy + 1`` distinct ranks, so any ``redundancy``
    simultaneous rank losses are recoverable.  Host memory per rank is
    ``(redundancy + 1)/k`` of the state size.

    Placement is the topology-aware stripe by default
    (:func:`stripe_placement`); ``MPI4JAX_TPU_ELASTIC_PLACEMENT=neighbor``
    (or ``placement='neighbor'``) takes the ring-neighbor table.  The
    table in force is recorded on the commit and restore follows it.

    ``comm`` may be ``None`` (the default comm, resolved lazily).
    ``rank`` pins the store to ONE global rank: the per-rank simulation
    handle of the chaos drills (``resilience/drill.py``); by default the
    store holds the shards of this process's rank.  ``topology``
    overrides the host map for placement (a per-host count tuple or a
    spec string such as ``'2x4'``); by default the declared
    ``MPI4JAX_TPU_TOPOLOGY`` spec where it covers the world.
    ``bootstrap`` holds what a re-bootstrap needs: ``rendezvous`` (the
    ``file://`` base of the per-epoch rendezvous, :func:`rendezvous_for`),
    ``host`` and ``port_base`` (the agreement's TCP), ``process_id``,
    ``num_processes`` and optionally ``backend`` (gloo), ``timeout``
    (the new process group's collective timeout), ``agree_port_base``
    and ``agree_timeout``.
    """

    def __init__(self, comm=None, *, redundancy: Optional[int] = None,
                 rank: Optional[int] = None, bootstrap: Optional[dict] = None,
                 topology=None, placement: Optional[str] = None):
        self.redundancy = (config.elastic_redundancy()
                           if redundancy is None else int(redundancy))
        if self.redundancy < 0:
            raise ValueError(
                f"redundancy must be >= 0, got {self.redundancy}")
        if placement is not None and placement not in ("stripe", "neighbor"):
            raise ValueError(
                f"placement must be 'stripe' or 'neighbor', got "
                f"{placement!r}")
        self._topology = topology
        self._placement_mode = placement
        self._comm = comm
        self._rank = rank
        self.bootstrap = dict(bootstrap or {})
        self._committed: Optional[dict] = None
        self._lock = threading.Lock()
        # the port's record of each recovery (failed ranks, restored step
        # and epoch; the seconds of the detection, the agreement, the
        # re-bootstrap and the restore), the interval commit_every='auto'
        # locked in, and the last commit's seconds (host copy and pack)
        self.recoveries: List[dict] = []
        self.auto_commit_every: Optional[int] = None
        self.last_commit_s: Optional[float] = None

    # -- world plumbing ----------------------------------------------------

    @property
    def comm(self):
        if self._comm is None:
            from ..parallel.region import get_default_comm

            self._comm = get_default_comm()
        return self._comm

    def world_size(self) -> int:
        return int(self.comm.world_size())

    def local_ranks(self) -> Tuple[int, ...]:
        """This process's rank (one process per rank), or the pinned
        ``rank``."""
        if self._rank is not None:
            return (self._rank,)
        return (int(self.comm.Get_rank()),)

    def placement_mode(self) -> str:
        """``'stripe'`` or ``'neighbor'``: the constructor override, else
        the declared ``MPI4JAX_TPU_ELASTIC_PLACEMENT`` flag."""
        return self._placement_mode or config.elastic_placement()

    def _topology_for(self, k: int):
        """Host map consulted for placement at world size ``k``: the
        explicit ``topology`` argument, else the declared
        ``MPI4JAX_TPU_TOPOLOGY`` spec when it covers ``k`` ranks, else
        ``None`` (one host: the stripe is the neighbor table)."""
        if self._topology is not None:
            return self._topology
        counts = config.parse_topology_spec(config.topology_spec())
        if counts is not None and sum(counts) == k:
            return counts
        return None

    def placement_table(self, k: Optional[int] = None
                        ) -> Tuple[Tuple[int, ...], ...]:
        """The replica placement table the next commit lands under."""
        k = self.world_size() if k is None else int(k)
        if self.placement_mode() == "neighbor":
            return neighbor_placement(k, self.redundancy)
        return stripe_placement(k, self.redundancy, self._topology_for(k))

    def held_shards(self, k: Optional[int] = None,
                    placement=None) -> Tuple[int, ...]:
        """Shards this process stores on commit: the union of
        :func:`placement_shards_held_by` over its local ranks."""
        k = self.world_size() if k is None else k
        table = self.placement_table(k) if placement is None else placement
        held = set()
        for r in self.local_ranks():
            if r < k:
                held.update(placement_shards_held_by(r, table))
        return tuple(sorted(held))

    # -- commit ------------------------------------------------------------

    def commit(self, step: int, state) -> None:
        """Commit ``state`` as of (completed) ``step``: copy each leaf to
        the host, pack, slice this rank's shards, and atomically replace
        the previous commit.  ``state`` must be identical on every rank;
        the commit moves no bytes over the network."""
        import numpy as np

        t0 = time.perf_counter()
        leaves, unflatten = _flatten_state(state)
        hosted = [_to_host(a) for a in leaves]
        buf, meta = pack_leaves([a for a, _ in hosted])
        k = self.world_size()
        table = self.placement_table(k)
        shard, padded = shard_bounds(buf.nbytes, k)
        if padded > buf.nbytes:
            buf = np.concatenate(
                [buf, np.zeros(padded - buf.nbytes, np.uint8)])
        shards = {
            s: bytes(buf[s * shard:(s + 1) * shard])
            for s in self.held_shards(k, table)
        }
        record = {
            "step": int(step),
            "epoch": current_epoch(),
            "k": k,
            "shard": shard,
            "nbytes": int(len(meta) and sum(m[2] for m in meta)),
            "meta": meta,
            "dtypes": [dt for _, dt in hosted],
            "unflatten": unflatten,
            "placement": table,
            "shards": shards,
        }
        with self._lock:
            self._committed = record
        self.last_commit_s = time.perf_counter() - t0
        _meter("elastic.commits")

    @property
    def committed_step(self) -> Optional[int]:
        with self._lock:
            return self._committed["step"] if self._committed else None

    @property
    def last_rank_map(self) -> Optional[Dict[int, int]]:
        """The ``{old_rank: new_rank}`` compaction the last shrink stamped
        on the committed record, or ``None`` when the commit pre-dates any
        reconfiguration (identity): what a restored per-rank artifact (the
        error-feedback residual, ``compress.ef_reshard``) needs to move
        its rows to their post-shrink owners."""
        with self._lock:
            rec = self._committed
            rmap = rec.get("rank_map") if rec else None
            return dict(rmap) if rmap is not None else None

    # -- restore -----------------------------------------------------------

    def _require_commit(self) -> dict:
        with self._lock:
            rec = self._committed
        if rec is None:
            raise RuntimeError(
                "ShardStore.restore: nothing committed yet — commit an "
                "initial state before entering the elastic loop so step-0 "
                "failures are recoverable"
            )
        return rec

    def _rec_placement(self, rec: dict) -> Tuple[Tuple[int, ...], ...]:
        """The placement table the commit was made under."""
        table = rec.get("placement")
        if table is None:
            table = neighbor_placement(rec["k"], self.redundancy)
        return table

    def restore_plan(self, failed: Iterable[int] = ()) -> Dict[int, int]:
        """Provider plan for restoring the last commit after losing
        ``failed``, computed against the placement table *recorded on the
        commit*, never against current flags.  Raises
        :class:`RankFailure` when some shard lost every holder."""
        rec = self._require_commit()
        return plan_from_placement(frozenset(failed),
                                   self._rec_placement(rec))

    def restore(self, failed: Iterable[int] = ()):
        """Reassemble the last committed state after losing ``failed``
        (old-world global ranks) and return ``(step, state)``: tensors
        on the comm's device where the committed leaves were tensors, the
        bytes unchanged.

        In a world of one rank, reassembly is local.  Otherwise every
        surviving rank joins the exchange, whatever shards it holds (the
        choice is collective: a rank that holds them all under a skewed
        placement must not skip the ``allreduce`` its peers block in).
        Each contributes the shards :meth:`restore_plan` makes it the
        provider of, zeros elsewhere, and ONE SUM ``allreduce`` of uint8
        over the *current* (post-shrink) comm reassembles the full buffer
        on every rank: exactly one contributor per shard, so the sum is
        placement and cannot wrap.  A loss the placement cannot recover
        raises :class:`RankFailure` before any exchange.
        """
        import numpy as np

        rec = self._require_commit()
        k, shard = rec["k"], rec["shard"]
        plan = plan_from_placement(frozenset(failed), self._rec_placement(rec))
        if self.world_size() == 1:
            buf = np.concatenate(
                [np.frombuffer(rec["shards"][s], np.uint8)
                 for s in range(k)]
            ) if shard else np.zeros((0,), np.uint8)
        else:
            buf = self._exchange_shards(rec, plan)
        mesh = getattr(self.comm, "mesh", None)
        state = _rebuild(rec, buf, mesh.device if mesh is not None else None)
        _meter("elastic.restores")
        return rec["step"], state

    def exchange_contribution(self, rec: dict, plan: Dict[int, int]):
        """This rank's flat contribution to the restore exchange: the
        shards it is the designated provider of, placed at their offsets,
        zeros elsewhere.  Summing every survivor's contribution reproduces
        the full committed buffer bit for bit."""
        import numpy as np

        k, shard = rec["k"], rec["shard"]
        contrib = np.zeros((k * shard,), np.uint8)
        for s, provider in plan.items():
            if s in rec["shards"] and self._provides(provider, rec):
                contrib[s * shard:(s + 1) * shard] = np.frombuffer(
                    rec["shards"][s], np.uint8)
        return contrib

    def _exchange_shards(self, rec: dict, plan: Dict[int, int]):
        """One SUM allreduce of uint8 over the current (post-shrink) comm
        moves every old-world shard from its designated provider to every
        rank.  Each rank contributes its own row (the port has one process
        per rank, so it builds no ``(size, k*shard)`` stack), on the comm's
        device; gloo stages a CUDA tensor through the host."""
        import torch

        from ..ops import SUM, allreduce

        comm = self.comm
        contrib = torch.from_numpy(self.exchange_contribution(rec, plan))
        out, _ = allreduce(contrib.to(comm.device), op=SUM, comm=comm)
        return out.cpu().numpy()

    def _provides(self, old_provider: int, rec: dict) -> bool:
        """Whether THIS process is the provider: it holds
        ``old_provider``'s rank now (through the rank map recorded on the
        commit after a shrink; old ranks ARE current ranks without one)."""
        rank_map = rec.get("rank_map")
        current = (old_provider if rank_map is None
                   else rank_map.get(old_provider))
        return current is not None and current in set(self.local_ranks())

    # -- the shrink --------------------------------------------------------

    def apply_shrink(self, failed: Iterable[int],
                     fail_unit: str = "rank") -> Dict[int, int]:
        """The JAX package's single-controller shrink, where one process
        drives every rank and rebuilds its mesh in place.  The port runs
        one process per rank, so a world of several processes always
        shrinks through :meth:`rebootstrap`, and this raises there.  A
        world of one process has no other rank to lose: losing its rank
        raises :class:`RankFailure` (no survivors), losing none rebinds
        the comm at the current epoch.  Returns the rank map."""
        import torch.distributed as dist

        from ..parallel.mesh import (forget_world, set_default_mesh,
                                     shrink_world_mesh)

        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise RuntimeError(
                "ShardStore.apply_shrink is the single-controller shrink; "
                f"this world has {dist.get_world_size()} processes, one per "
                "rank, so it shrinks through ShardStore.rebootstrap (give "
                "the store bootstrap=)")
        comm = self.comm
        grid = comm.mesh
        if grid is None:
            raise RuntimeError("elastic shrink needs a comm bound to a grid")
        dead = expand_fail_unit(failed, grid.shape, fail_unit)
        rank_map = compact_rank_map(comm.world_size(), dead)
        new_mesh = shrink_world_mesh(grid, dead, fail_unit)
        self._comm = comm.shrink(dead, mesh=new_mesh)
        forget_world()
        set_default_mesh(new_mesh)
        with self._lock:
            if self._committed is not None:
                self._committed["rank_map"] = dict(rank_map)
        if self._rank is not None and self._rank in rank_map:
            self._rank = rank_map[self._rank]
        return rank_map

    def _require_bootstrap(self) -> dict:
        bs = self.bootstrap
        for key in ("rendezvous", "host", "port_base", "process_id",
                    "num_processes"):
            if key not in bs:
                raise RuntimeError(
                    "elastic rebootstrap needs ShardStore(bootstrap="
                    "{'rendezvous', 'host', 'port_base', 'process_id', "
                    f"'num_processes'}}); missing {key!r}"
                )
        return bs

    def _reinit_distributed(self, new_world: int, me_new: int,
                            device) -> None:
        """Tear the revoked process group down and initialise a fresh one
        over the survivors at the current epoch's rendezvous
        (:func:`rendezvous_for`).  ``init_distributed`` retries the
        rendezvous (``MPI4JAX_TPU_BOOTSTRAP_DEADLINE``) and raises when
        it cannot complete: a failed re-bootstrap is an error, never a
        fallback."""
        from ..parallel.mesh import init_distributed

        bs = self.bootstrap
        _teardown_process_group()
        _drop_world()
        init_distributed(
            bs.get("backend", "gloo"),
            init_method=rendezvous_for(bs["rendezvous"], current_epoch()),
            world_size=new_world, rank=me_new, device=device,
            timeout=float(bs.get("timeout", 300.0)))
        bs["process_id"] = me_new
        bs["num_processes"] = new_world

    def rebootstrap(self, failed: Iterable[int],
                    fail_unit: str = "rank") -> Dict[int, int]:
        """Multi-process shrink: tear the old process group down and
        initialise a new one over the survivors (compacted ranks), then
        rebuild the grid (``fail_unit`` widens the removal to whole grid
        rows or columns, and the grid keeps its Cartesian shape minus the
        dead rows), the default grid and this store's comm.  Requires
        ``bootstrap``.  Returns the old->new rank map."""
        from ..parallel.mesh import make_world_mesh, set_default_mesh

        bs = self._require_bootstrap()
        old = self.comm.mesh
        old_axes = tuple(old.axes) if old is not None else None
        old_shape = (tuple(old.shape) if old is not None
                     else (int(bs["num_processes"]),))
        device = old.device if old is not None else None
        dead = expand_fail_unit(failed, old_shape, fail_unit)
        if len(old_shape) > 1 and fail_unit in ("row", "col"):
            _meter("elastic.row_shrinks")
        world = int(bs["num_processes"])
        rank_map = compact_rank_map(world, dead)
        me_old = int(bs["process_id"])
        if me_old in dead or me_old not in rank_map:
            raise RankFailure(dead, "this rank was declared failed")
        me_new = rank_map[me_old]
        new_world = len(rank_map)
        # the launch ranks first: the journal names this process by its
        # launch rank (telemetry/journal.py:process_index) from here on
        _renumber_origin(rank_map)
        self._reinit_distributed(new_world, me_new, device)

        new_shape = shrunken_shape(old_shape, dead,
                                   fail_unit if len(old_shape) > 1
                                   else "rank")
        new_mesh = make_world_mesh(new_shape, old_axes, device=device)
        set_default_mesh(new_mesh)
        self._comm = self.comm.shrink(dead, mesh=new_mesh)
        with self._lock:
            if self._committed is not None:
                self._committed["rank_map"] = dict(rank_map)
        if self._rank is not None:
            self._rank = rank_map.get(self._rank, self._rank)
        return rank_map

    def multiprocess(self) -> bool:
        return bool(self.bootstrap)


def reassemble_from_stores(stores: Dict[int, "ShardStore"],
                           failed: Iterable[int] = ()):
    """Pure simulation of the restore exchange: given per-rank stores
    (``{old_rank: rank-pinned ShardStore}``), reassemble ``(step, state)``
    from the SURVIVING stores only, byte for byte what the one-allreduce
    runtime exchange produces.  Kill any ``redundancy`` stores and the
    state must still come back bit-identical."""
    import numpy as np

    dead = frozenset(failed)
    survivors = {r: s for r, s in stores.items() if r not in dead}
    if not survivors:
        raise RankFailure(dead, "no surviving stores")
    first = next(iter(survivors.values()))
    rec = first._require_commit()
    k, shard = rec["k"], rec["shard"]
    plan = plan_from_placement(dead, first._rec_placement(rec))
    buf = np.zeros((k * shard,), np.uint8)
    for s, provider in plan.items():
        prec = survivors[provider]._require_commit()
        buf[s * shard:(s + 1) * shard] = np.frombuffer(
            prec["shards"][s], np.uint8)
    return rec["step"], _rebuild(rec, buf, None)


# ---------------------------------------------------------------------------
# revoke: make the old world unreachable
# ---------------------------------------------------------------------------


def revoke_epoch(failed: Iterable[int], *, rank: int = 0,
                 world: Optional[int] = None, cause: str = "failure") -> int:
    """Revoke the current comm epoch at a shrink boundary:

    - advance the epoch (every comm of the old one refuses collectives,
      MPX126; every pin refuses its next call, MPX129), recording the
      shrink in :func:`epoch_history`;
    - drain the watchdog's in-flight registries (arms from collectives of
      the revoked world must not fire in the recovered job);
    - drop the resilience plan memo (``ops/_base.clear_caches``);
    - journal exactly one ``epoch_change`` telemetry incident.

    Returns the new epoch.
    """
    from ..ops import _base
    from . import watchdog as _wd

    dead = sorted(frozenset(failed))
    new_world = (world - len(dead)) if world else None
    detail = (f"shrank out rank(s) {dead}"
              + (f" of {world}" if world else ""))
    new_epoch = advance_epoch(world=new_world, cause=cause, detail=detail)
    _wd.drain_registry()
    _base.clear_caches()
    _incident(
        "elastic.epoch_changes", "epoch_change", rank,
        f"epoch {new_epoch - 1} -> {new_epoch}: {detail}",
    )
    return new_epoch


# ---------------------------------------------------------------------------
# the elastic training loop
# ---------------------------------------------------------------------------

# the commit_every='auto' target: commits cost at most this fraction of the
# step time (the JAX package's autotune/fit.py default; the port has no
# tuning layer to read another from)
DEFAULT_COMMIT_OVERHEAD = 0.05
MAX_COMMIT_INTERVAL = 1024


def align_commit_every(commit_every: int, unroll: int) -> int:
    """Round a commit interval UP to a multiple of the megastep trip
    count: state only exists at megastep boundaries
    (``aot/pinning.py:ElasticStep``), so commits can only land there."""
    if unroll <= 1:
        return commit_every
    return ((commit_every + unroll - 1) // unroll) * unroll


def resolve_auto_commit_interval(step_time_s: float,
                                 commit_cost_s: float) -> int:
    """The ``commit_every='auto'`` decision: the smallest ``n`` with
    ``commit_cost <= 0.05 * n * step_time`` (the measured commit against
    the measured step), clamped to ``[1, 1024]``; a non-positive step
    time gives 1 (commit every step).  The formula of the JAX package's
    ``autotune/fit.py:auto_commit_interval`` at its default target."""
    import math

    if step_time_s <= 0 or commit_cost_s < 0:
        return 1
    n = math.ceil(commit_cost_s / (DEFAULT_COMMIT_OVERHEAD * step_time_s))
    return max(1, min(int(n), MAX_COMMIT_INTERVAL))


def run(step_fn, state, store: ShardStore, *, steps: int,
        start_step: int = 0, commit_every=1, claim_watchdog: bool = True):
    """Run ``state = step_fn(state, step, comm)`` for ``steps`` steps,
    surviving rank loss: on a :class:`RankFailure` (raised by the step,
    posted by the claimed watchdog, or classified from a distributed
    death rattle) the loop agrees on the failed set with the surviving
    peers, revokes the epoch, shrinks the world (a re-bootstrap over the
    survivors), restores the last committed state, and continues on
    ``k - f`` ranks from the committed step.

    ``step_fn`` takes the CURRENT comm: after a shrink it is a new
    (smaller, new-epoch) comm.  ``commit_every`` bounds the recovery
    replay window; the initial state is committed before ``start_step``
    so a first-step failure is recoverable.  ``commit_every='auto'``
    commits every boundary until it has timed one step after the first
    (which carries one-time costs) and one commit, then locks in
    :func:`resolve_auto_commit_interval`, the largest over the ranks (so
    that every rank commits at the same steps).  A step function with an
    ``unroll`` attribute (``aot.compile_step(fn, unroll=N)``) runs N steps
    a call: the loop advances by N, ``commit_every`` is rounded up to a
    multiple of N, and ``steps - start_step`` must be one.  A
    ``StaleProgramError`` (MPX129) from a pinned step re-pins
    (``step_fn.repin()``) and retries the same step.

    ``claim_watchdog=True`` installs the elastic expiry handler for the
    duration of the loop (through the Python registry, since the C++
    monitor cannot hand an expiry to Python), so an expiry becomes a
    recovery instead of a process kill; in the main thread it also
    installs a SIGINT handler that lets the claim interrupt a step
    waiting in Python.  The JAX package's loop also installs a SIGTERM
    handler that turns a preemption notice into a graceful drain; the
    drain half is not ported (ROADMAP Queue 1 item 3), so this one
    installs none, and ``MPI4JAX_TPU_ELASTIC_GROW`` raises
    ``NotImplementedError``.
    """
    from . import watchdog as _wd

    if config.elastic_grow():
        raise NotImplementedError(GROW_NOT_PORTED)
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    auto_commit: Optional[dict] = None
    if isinstance(commit_every, str):
        if commit_every != "auto":
            raise ValueError(
                f"commit_every must be an int >= 1 or 'auto', got "
                f"{commit_every!r}"
            )
        auto_commit = {"step_s": None, "commit_s": None, "warm": False}
        commit_every = 1
    if commit_every < 1:
        raise ValueError(f"commit_every must be >= 1, got {commit_every}")

    stride = getattr(step_fn, "unroll", 1) or 1
    try:
        stride = max(1, int(stride))
    except (TypeError, ValueError):
        stride = 1
    if stride > 1:
        if (steps - start_step) % stride:
            raise ValueError(
                f"steps - start_step ({steps - start_step}) must be a "
                f"multiple of the step function's megastep unroll "
                f"({stride}): a pinned megastep cannot run a partial "
                "trip (pad the budget or drop unroll)"
            )
        commit_every = align_commit_every(commit_every, stride)

    from ..aot.invalidation import StaleProgramError as _Stale

    claimed = False
    prev_handler = prev_fallback = None
    if claim_watchdog:
        prev_handler = _wd._registry.on_timeout
        prev_fallback = _wd._force_fallback
        _wd.set_on_timeout(_claimed_on_timeout)
        _wd.force_python_fallback(True)
        claimed = True
        _install_interrupt()
    try:
        if store.committed_step is None:
            store.commit(start_step, state)
        step = start_step
        while step < steps:
            try:
                t_step = time.perf_counter()
                _Interrupt.in_step = True
                try:
                    state = step_fn(state, step, store.comm)
                    _block_on(state)
                finally:
                    _Interrupt.in_step = False
                if auto_commit is not None and auto_commit["step_s"] is None:
                    if auto_commit["warm"]:
                        auto_commit["step_s"] = \
                            (time.perf_counter() - t_step) / stride
                    else:
                        auto_commit["warm"] = True
                step += stride
                committed = False
                if (step - start_step) % commit_every == 0 or step == steps:
                    t_commit = time.perf_counter()
                    store.commit(step, state)
                    if (auto_commit is not None
                            and auto_commit["commit_s"] is None):
                        auto_commit["commit_s"] = \
                            time.perf_counter() - t_commit
                    committed = True
                if (auto_commit is not None
                        and auto_commit["step_s"] is not None
                        and auto_commit["commit_s"] is not None):
                    commit_every = align_commit_every(
                        _agreed_interval(store, resolve_auto_commit_interval(
                            auto_commit["step_s"],
                            auto_commit["commit_s"])),
                        stride)
                    store.auto_commit_every = commit_every
                    auto_commit = None
                    _meter("elastic.auto_commits")
                _health_boundary(store, step, committed)
            except _Stale:
                repin = getattr(step_fn, "repin", None)
                if repin is None:
                    raise
                step_fn = repin() or step_fn
                _meter("elastic.repins")
            except BaseException as exc:  # noqa: B036 - KeyboardInterrupt too
                rf = classify_failure(exc)
                if rf is None:
                    raise
                detect_s = time.perf_counter() - t_step
                _health_failure(rf)
                step, state = _recover(rf, store, detect_s)
        return state
    finally:
        if claimed:
            _uninstall_interrupt()
            _wd.set_on_timeout(prev_handler)
            _wd.force_python_fallback(prev_fallback)


def _agreed_interval(store: ShardStore, interval: int) -> int:
    """The largest of every rank's ``commit_every='auto'`` interval (a MAX
    ``allreduce`` over the store's comm; every rank locks in at the same
    boundary).  Each rank times its own step and commit, so the intervals
    can differ, and ranks that commit at different steps would restore
    shards of different steps (the JAX package's loop has no such
    exchange)."""
    import torch

    from ..ops import MAX, allreduce

    comm = store.comm
    if comm.world_size() == 1:
        return interval
    mine = torch.tensor([int(interval)], dtype=torch.int64, device=comm.device)
    agreed, _ = allreduce(mine, op=MAX, comm=comm)
    return int(agreed[0])


def _block_on(state) -> None:
    """Wait for the step's device work INSIDE the try: a peer's death
    must surface here (as an error or a watchdog expiry), not at an
    uninstrumented later use.  ``torch.cuda.synchronize`` on each CUDA
    device the state lives on."""
    import torch

    from ..utils.tree import tree_leaves

    devices = {t.device for t in tree_leaves(state)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


def _recover(rf: RankFailure, store: ShardStore, detect_s: float = 0.0):
    """The shrink-and-resume sequence: agree -> revoke -> shrink ->
    restore.  In a world of several processes this rank first destroys
    its process group (a peer still blocked with it fails at once), then
    agrees over TCP; a rank its own failure names leaves at once.  The agreed failed set is widened to the declared
    fail unit (``MPI4JAX_TPU_ELASTIC_FAIL_UNIT``) before the shrink.
    ``detect_s`` (the seconds from the failed step's start to the
    classification) goes into the recovery's record.  Returns
    ``(committed_step, state)``."""
    _meter("elastic.failures_detected")
    comm = store.comm
    world = int(store.bootstrap.get("num_processes") or comm.world_size())
    t0 = time.perf_counter()

    if store.multiprocess():
        bs = store.bootstrap
        my_rank = int(bs["process_id"])
        _teardown_process_group()
        if my_rank in rf.suspects:
            # named by its own failure (a simulated loss, the health
            # plane's verdict on this rank): the survivors' agreement waits
            # for no suspect, so this rank leaves now rather than report
            # into a round that may have closed
            raise RankFailure(rf.suspects, "this rank was declared failed "
                                           "by its own failure") from rf
        failed = negotiate_failed(
            my_rank, world, rf.suspects, bs["host"],
            agree_port_no=agree_port(int(bs["port_base"]),
                                     current_epoch()),
            gossip_port_base=int(bs.get("agree_port_base",
                                        int(bs["port_base"]) + 1000))
            + 17 * wrapped_epoch(current_epoch()),
            timeout=float(bs.get("agree_timeout", 20.0)),
        )
        if my_rank in failed:
            raise RankFailure(failed, "this rank was declared failed by "
                                      "its peers") from rf
    else:
        my_rank = 0
        failed = frozenset(rf.suspects)
    _meter("elastic.agreements")
    t_agreed = time.perf_counter()

    if not failed:
        raise RankFailure(
            (), "failure agreement produced an empty failed set: the "
                "suspects were not confirmed and no peer is unreachable — "
                "refusing to shrink a healthy world"
        ) from rf
    if not majority_survives(failed, world):
        raise RankFailure(
            failed,
            f"only {world - len(failed)} of {world} ranks survive — below "
            "the majority threshold (split-brain guard): aborting instead "
            "of training a divergent minority partition",
        ) from rf
    _health_rank_failed(failed, rf)
    unit = config.elastic_fail_unit()
    mesh = getattr(comm, "mesh", None)
    mesh_shape = tuple(mesh.shape) if mesh is not None else (world,)
    removed = expand_fail_unit(failed, mesh_shape, unit)
    if store.multiprocess() and my_rank in removed:
        raise RankFailure(
            removed,
            f"this rank's grid {unit} contains failed rank(s) "
            f"{sorted(failed)} — shrunk out with them (fail_unit={unit})",
        ) from rf
    if store.multiprocess():
        store.restore_plan(removed)

    revoke_epoch(removed, rank=my_rank, world=world)
    if store.multiprocess():
        store.rebootstrap(removed, unit)
    else:
        store.apply_shrink(removed, unit)
    t_boot = time.perf_counter()
    step, state = store.restore(removed)
    _block_on(state)
    t_restored = time.perf_counter()
    store.recoveries.append({
        "failed": sorted(failed), "step": step, "epoch": current_epoch(),
        "detect_s": detect_s,
        "agree_s": t_agreed - t0, "rebootstrap_s": t_boot - t_agreed,
        "restore_s": t_restored - t_boot,
    })
    _meter("elastic.resumes")
    return step, state
