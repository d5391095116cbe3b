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

4. **Drain.**  A preemption notice (a SIGTERM through the handler
   :func:`run` installs, the ``preempt`` fault verb, or
   :func:`request_drain`) marks this rank as leaving.  At its next step
   boundary the leaver announces the leave boundary to every peer's
   control listener and collects their acks (:func:`notify_drain`); at
   that boundary every rank forces a commit and executes a planned
   shrink (widened to the fail unit): no detection, no agreement, no
   restore, one ``drain`` incident.  The leavers return with
   ``store.drained`` set; a collective on their sealed comm raises MPX127
   (``ops/_base.py:check_comm``).
5. **Grow.**  Under ``MPI4JAX_TPU_ELASTIC_GROW`` rank 0 listens for
   replacement processes (:func:`request_join`, :func:`join_and_run`).
   At the next commit boundary one tiny SUM ``allreduce`` tells every
   rank how many knocked; the epoch advances with a positive delta, rank
   0 sends each joiner its admit message (epoch, rank, world, the
   commit's JSON description, its launch rank, the commit interval), and
   every process re-bootstraps at ``k + j``
   (:meth:`ShardStore.rebootstrap_grow`, survivors keep their ranks); the
   committed state streams to the joiners through the restore exchange's
   cold branch (the joiner contributes zeros).

:class:`BoundaryControl` runs the drain and grow boundary actions for a
loop other than :func:`run`.

The pure half (epochs, placement, renumbering, ports, the agreement
models and their TCP runtime, failure classification, byte packing)
needs no torch; everything that moves tensors imports it lazily.
"""

from __future__ import annotations

import json
import os
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
    "request_drain",
    "take_pending_drain",
    "install_preemption_handler",
    "mark_comm_draining",
    "seal_drained_comm",
    "comm_draining",
    "comm_drained",
    "post_simulated_join",
    "pending_join_count",
    "request_join",
    "notify_drain",
    "BoundaryControl",
    "join_and_run",
]

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
# renumbered them or a grow appended to them (None: the identity).  Fault
# clauses address the launch world's ranks (resilience/faultinject.py), so
# that a drill that hangs rank 2 does not hang the survivor renumbered 2
# after the shrink.
_rank_origin: Optional[Tuple[int, ...]] = None
# launch ranks issued so far: the launch world's size, then one more for
# each joiner a grow admits, so that a joiner never takes a launch rank a
# fault clause already names (None until the first boundary needs it)
_origins_issued: Optional[int] = None


def current_epoch() -> int:
    """The current communication epoch (0 until the first revocation)."""
    return _epoch


def advance_epoch(*, world: Optional[int] = None, cause: str = "revoke",
                  detail: str = "") -> int:
    """Revoke the current epoch: bump the counter (every comm and pin of
    the old one is refused from now on) and the configuration epoch.
    ``world``/``cause``/``detail`` describe the boundary for
    :func:`epoch_history` (``cause`` is ``"failure"`` for a shrink,
    ``"drain"`` and ``"join"`` for the planned boundaries, ``"revoke"``
    for a bare revocation).  Returns the new epoch."""
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


def _set_epoch(n: int) -> None:
    """Adopt an epoch the world agreed on (a joiner admitted into epoch
    ``n`` stamps its comms as the world does).  Never moves backwards."""
    global _epoch
    with _epoch_lock:
        if n < _epoch:
            raise ValueError(
                f"cannot move the epoch backwards ({_epoch} -> {n})")
        if n > _epoch:
            _epoch = n
            _epoch_history.append({
                "epoch": n, "world": None, "cause": "adopt", "detail": "",
            })
    config.bump_config_epoch()


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


def _count_launch_ranks(world: Optional[int]) -> None:
    """Start the counter of launch ranks issued at the launch world's size
    (``world``, the size of a world no boundary renumbered yet)."""
    global _origins_issued
    if _origins_issued is None:
        if world is None:
            world = max(_rank_origin) + 1 if _rank_origin else 0
        _origins_issued = int(world)


def _renumber_origin(rank_map: Dict[int, int],
                     world: Optional[int] = None) -> None:
    """Compose a shrink's ``{old: new}`` rank map into the origin map;
    ``world`` is the size of the world it shrinks."""
    global _rank_origin
    if _rank_origin is None:
        _count_launch_ranks(world if world is not None
                            else max(rank_map, default=-1) + 1)
    new = [0] * len(rank_map)
    for old, cur in rank_map.items():
        new[cur] = origin_rank(old)
    _rank_origin = tuple(new)


def _issue_origins(world: int, added: int) -> Tuple[int, ...]:
    """The launch ranks of ``added`` joiners of a world of ``world``: the
    next ones the counter has not issued (every rank moves it the same
    way at the same boundary)."""
    global _origins_issued
    with _epoch_lock:
        if _rank_origin is None:
            _count_launch_ranks(world)
        else:
            _count_launch_ranks(None)
        out = tuple(range(_origins_issued, _origins_issued + int(added)))
        _origins_issued += int(added)
    return out


def _append_origins(world: int, origins) -> None:
    """A grow's origin map: the ``world`` ranks keep theirs, the joiners'
    launch ranks follow."""
    global _rank_origin
    _rank_origin = (tuple(origin_rank(r) for r in range(int(world)))
                    + tuple(int(o) for o in origins))


def _adopt_origins(origins, issued: Optional[int]) -> None:
    """A joiner takes the world's origin map and counter from its admit."""
    global _rank_origin, _origins_issued
    if origins is not None:
        _rank_origin = tuple(int(o) for o in origins)
    if issued is not None:
        _origins_issued = int(issued)


def _reset_epoch_for_tests() -> None:
    global _epoch, _rank_origin, _origins_issued
    with _epoch_lock:
        _epoch = 0
        del _epoch_history[:]
    _rank_origin = None
    _origins_issued = None
    with _drain_lock:
        _pending_drain.clear()
        _peer_drain.clear()
        _peer_drain_at[:] = []
        _draining_comms.clear()
        _drained_comms.clear()
    with _join_lock:
        for j in _pending_joins:
            if j.get("conn") is not None:
                j["conn"].close()
        del _pending_joins[:]
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


# the largest control message read (an admit carries the commit's JSON
# description: a few hundred bytes a leaf): a peer that is not one of these
# listeners cannot make a reader allocate what its first bytes claim
_JSON_LIMIT = 16 << 20


def _recv_json(conn) -> dict:
    header = _recv_all(conn, 8)
    if len(header) < 8:
        raise OSError("connection closed before header")
    n = int.from_bytes(header, "big")
    if n > _JSON_LIMIT:
        raise OSError(f"a control message of {n} bytes (over {_JSON_LIMIT}): "
                      "not an elastic listener")
    return json.loads(_recv_all(conn, n).decode())


# what the join and control listeners say first on every connection: a
# client sends nothing to a listener that does not, so a port reused by
# another service (a gloo pair's, say) never receives its bytes
_JOIN_BANNER = b"mpi4jax_tpu_torch elastic join\n"
_CONTROL_BANNER = b"mpi4jax_tpu_torch elastic control\n"


def _expect_banner(conn, banner: bytes, timeout: float = 2.0) -> None:
    conn.settimeout(timeout)
    if _recv_all(conn, len(banner)) != banner:
        raise OSError("not an elastic listener")


# ---------------------------------------------------------------------------
# graceful drain: announced departures instead of detected deaths
# ---------------------------------------------------------------------------
#
# A preemption notice (SIGTERM, the scheduler's eviction warning, or the
# ``preempt`` fault verb) marks this rank as *leaving*.  The elastic loop
# picks the mark up at its next step boundary, announces the leave boundary
# to every peer (with acks, so nobody can race past it), forces an early
# ``store.commit`` there and executes a PLANNED shrink: no watchdog expiry,
# no agreement round, exactly one ``drain`` incident.

_drain_lock = threading.Lock()
_pending_drain: dict = {}       # this process wants to leave (or a
#                                 simulated rank does): {"rank", "grace"}
_peer_drain: dict = {}          # a peer announced its departure:
#                                 {"rank", "boundary"}
_peer_drain_at: List[float] = []  # when that notice landed (time.time())
_draining_comms: Dict[int, int] = {}   # comm uid -> scheduled leave boundary
_drained_comms: Dict[int, int] = {}    # comm uid -> passed leave boundary


def request_drain(grace: Optional[float] = None, *,
                  rank: Optional[int] = None) -> None:
    """Mark a rank as *leaving* (idempotent).  ``rank=None`` means the
    calling process (the SIGTERM path); a concrete rank is a current
    global rank (the ``preempt`` verb posts its own) or, in a world of one
    process, the simulated rank to drain.  The elastic loop executes the
    drain at its next step boundary; ``grace`` bounds the peer-ack wait
    (default ``MPI4JAX_TPU_DRAIN_GRACE_S``)."""
    with _drain_lock:
        if not _pending_drain:
            _pending_drain.update({
                "rank": None if rank is None else int(rank),
                "grace": grace,
            })


def take_pending_drain() -> Optional[dict]:
    """Pop the pending drain request, if any."""
    with _drain_lock:
        if not _pending_drain:
            return None
        out = dict(_pending_drain)
        _pending_drain.clear()
    return out


def _post_peer_drain(rank: int, boundary: int) -> None:
    with _drain_lock:
        if not _peer_drain:
            _peer_drain.update({"rank": int(rank),
                                "boundary": int(boundary)})
            _peer_drain_at[:] = [time.time()]


def peek_peer_drain() -> Optional[dict]:
    with _drain_lock:
        return dict(_peer_drain) if _peer_drain else None


def take_peer_drain() -> Optional[dict]:
    with _drain_lock:
        if not _peer_drain:
            return None
        out = dict(_peer_drain)
        _peer_drain.clear()
    return out


def _preemption_handler(grace: Optional[float]):
    def _on_term(_signo, _frame):
        _meter("elastic.preempt_notices")
        request_drain(grace)

    _on_term.mpx_preemption = True
    return _on_term


def install_preemption_handler(grace: Optional[float] = None, *,
                               signum=None):
    """Install a SIGTERM handler that posts a drain request (the
    graceful-preemption entry: schedulers announce evictions with SIGTERM
    before the kill).  Returns the previous handler (pass it to
    ``signal.signal`` to restore), or ``None`` where no handler can be
    installed (not the main thread): the elastic loop then has only the
    failure path for an eviction."""
    import signal as _signal

    signum = _signal.SIGTERM if signum is None else signum
    if threading.current_thread() is not threading.main_thread():
        return None
    try:
        return _signal.signal(signum, _preemption_handler(grace))
    except (ValueError, OSError):
        return None


def _restore_sigterm(prev) -> None:
    """Put back the handler :func:`install_preemption_handler` returned."""
    import signal as _signal

    if prev is None:
        return
    try:
        _signal.signal(_signal.SIGTERM, prev)
    except (ValueError, OSError):
        pass


def mark_comm_draining(comm_or_uid, boundary: int) -> None:
    """Record that ``comm``'s world has a scheduled leave boundary.
    Collectives remain legal through the boundary; once
    :func:`seal_drained_comm` runs the comm is *drained* and any further
    collective on it raises MPX127."""
    uid = getattr(comm_or_uid, "uid", comm_or_uid)
    with _drain_lock:
        _draining_comms[int(uid)] = int(boundary)


def seal_drained_comm(comm_or_uid) -> None:
    """The leave boundary passed: collectives on this comm are now errors
    (MPX127); its world executed its planned shrink."""
    uid = int(getattr(comm_or_uid, "uid", comm_or_uid))
    with _drain_lock:
        boundary = _draining_comms.pop(uid, 0)
        _drained_comms[uid] = boundary


def comm_draining(comm_or_uid) -> Optional[int]:
    """The scheduled leave boundary of a draining comm, or ``None``."""
    uid = int(getattr(comm_or_uid, "uid", comm_or_uid))
    with _drain_lock:
        return _draining_comms.get(uid)


def comm_drained(comm_or_uid) -> bool:
    """True once the comm's leave boundary passed (MPX127 territory)."""
    uid = int(getattr(comm_or_uid, "uid", comm_or_uid))
    with _drain_lock:
        return uid in _drained_comms


# ---------------------------------------------------------------------------
# grow: admit replacement ranks at an epoch boundary
# ---------------------------------------------------------------------------
#
# A replacement process contacts the CURRENT coordinator (the join listener
# derived from ``port_base`` and the wrapped epoch, which rank 0 names in a
# file beside the world's rendezvous: the joiner cannot know how many
# epochs passed while it was being scheduled), parks on the open
# connection, and is admitted at the world's next commit boundary: the world advances one epoch with a positive delta,
# every process re-bootstraps at world + J, and the committed state is
# streamed to the joiner through the restore exchange's cold branch (the
# joiner contributes zeros and receives everything).

_join_lock = threading.Lock()
_pending_joins: List[dict] = []   # [{"conn": socket|None, "info": dict}]


def post_simulated_join(count: int = 1) -> None:
    """Queue ``count`` simulated joiners (a scripted store's drills: the
    replacement is re-admitted by the store's ``apply_grow``)."""
    with _join_lock:
        for _ in range(int(count)):
            _pending_joins.append({"conn": None, "info": {"simulated": True}})


def pending_join_count() -> int:
    with _join_lock:
        return len(_pending_joins)


def _take_pending_joins() -> List[dict]:
    with _join_lock:
        out, _pending_joins[:] = list(_pending_joins), []
    return out


class _JoinServer:
    """The coordinator's join listener (rank 0 only, one epoch at a time):
    accepts ``{"kind": "join"}`` hellos and parks each connection in the
    pending-join queue; the admit message goes out on it at the next commit
    boundary."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, int(port)
        self._stop = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, self.port))
        self._srv.listen(8)
        self._srv.settimeout(0.2)
        self._thread = threading.Thread(
            target=self._serve, name="mpi4jax_tpu_torch-join", daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                try:
                    conn.settimeout(10.0)
                    conn.sendall(_JOIN_BANNER)
                    payload = _recv_json(conn)
                    if payload.get("kind") != "join":
                        conn.close()
                        continue
                    conn.settimeout(None)
                    with _join_lock:
                        _pending_joins.append(
                            {"conn": conn, "info": payload})
                except (OSError, ValueError, KeyError):
                    conn.close()
        finally:
            self._srv.close()

    def stop(self):
        self._stop.set()


def _join_file(rendezvous: Optional[str]) -> Optional[str]:
    """Where rank 0 names its live join listener beside a ``file://``
    rendezvous: ``<path>.join``."""
    if not rendezvous or not str(rendezvous).startswith("file://"):
        return None
    return str(rendezvous)[len("file://"):] + ".join"


def _publish_join_port(rendezvous: Optional[str], host: str, port: int,
                       epoch: int) -> None:
    path = _join_file(rendezvous)
    if path is None:
        return
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"host": host, "port": int(port), "epoch": int(epoch)}, f)
    os.replace(tmp, path)


def _published_join_port(path: str) -> Optional[Tuple[str, int]]:
    """``(host, port)`` of the join listener named in ``path``, if any."""
    try:
        with open(path) as f:
            rec = json.load(f)
        return str(rec["host"]), int(rec["port"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


def request_join(rendezvous: str, *, timeout: float = 300.0,
                 poll_interval: float = 0.1) -> dict:
    """The replacement process's half of the join protocol: read the join
    listener rank 0 names beside the world's ``file://`` ``rendezvous``
    (``<path>.join``; the JAX package scans the declared port window
    instead, which here would poke other services' ports), send a join
    hello, and block until the coordinator admits us at a commit boundary.
    Nothing is sent to a listener that does not greet first as a join
    listener.  Returns the admit message (the JAX package's ``{"epoch",
    "process_id", "num_processes", "step", "commit", "axes"}``, and the
    port's ``origin``, ``origins``, ``launch_ranks_issued``,
    ``comm_uid``, ``commit_every``, ``commit_anchor`` and
    ``auto_commit``).  Raises ``RuntimeError`` when no coordinator admits
    us within ``timeout``."""
    path = _join_file(rendezvous)
    if path is None:
        raise ValueError(
            f"request_join needs the world's file:// rendezvous, got "
            f"{rendezvous!r}")
    deadline = time.monotonic() + timeout
    hello = {"kind": "join", "host": socket.gethostname()}
    while time.monotonic() < deadline:
        where = _published_join_port(path)
        if where is not None:
            try:
                conn = socket.create_connection(where, timeout=0.3)
            except OSError:
                conn = None
            if conn is not None:
                try:
                    _expect_banner(conn, _JOIN_BANNER)
                    conn.settimeout(max(1.0, deadline - time.monotonic()))
                    _send_json(conn, hello)
                    admit = _recv_json(conn)     # parks until the boundary
                    if admit.get("kind") == "admit":
                        return admit
                except (OSError, ValueError):
                    pass
                finally:
                    conn.close()
        time.sleep(poll_interval)
    raise RuntimeError(
        f"request_join: no coordinator admitted us within {timeout:g}s "
        f"(the join listener named in {path}; is the running world's "
        "MPI4JAX_TPU_ELASTIC_GROW on?)"
    )


# ---------------------------------------------------------------------------
# control plane: drain notices between peers
# ---------------------------------------------------------------------------


class _ControlServer:
    """Per-rank control listener (one epoch at a time): receives drain
    notices from a departing peer, posts them for the run loop, and acks
    at once; the ack is what lets the leaver prove every peer knows the
    leave boundary before anyone steps toward it."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, int(port)
        self._stop = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, self.port))
        self._srv.listen(8)
        self._srv.settimeout(0.2)
        self._thread = threading.Thread(
            target=self._serve, name="mpi4jax_tpu_torch-control",
            daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                with conn:
                    try:
                        conn.settimeout(5.0)
                        conn.sendall(_CONTROL_BANNER)
                        payload = _recv_json(conn)
                        if payload.get("kind") == "drain":
                            _post_peer_drain(payload["rank"],
                                             payload["boundary"])
                            _send_json(conn, {"kind": "ack"})
                    except (OSError, ValueError, KeyError):
                        continue
        finally:
            self._srv.close()

    def stop(self):
        self._stop.set()


def notify_drain(host: str, port_base: int, my_rank: int, world: int,
                 boundary: int, *, epoch: Optional[int] = None,
                 grace: Optional[float] = None) -> List[int]:
    """Send the drain notice to every peer's control port and collect acks
    (bounded by ``grace``).  Returns the ranks that did NOT ack: they may
    be dead, which the ordinary failure path will discover; the drain
    proceeds regardless (an eviction deadline does not wait)."""
    epoch = current_epoch() if epoch is None else epoch
    grace = config.drain_grace_s() if grace is None else float(grace)
    notice = {"kind": "drain", "rank": int(my_rank),
              "boundary": int(boundary)}
    unacked = []
    deadline = time.monotonic() + grace
    for peer in range(world):
        if peer == my_rank:
            continue
        acked = False
        try:
            port = control_port(port_base, peer, epoch)
        except ValueError:
            # a rank beyond the declared span has no control listener
            unacked.append(peer)
            continue
        while time.monotonic() < deadline and not acked:
            try:
                with socket.create_connection(
                    (host, port),
                    timeout=max(0.1, deadline - time.monotonic()),
                ) as c:
                    _expect_banner(c, _CONTROL_BANNER,
                                   max(0.1, deadline - time.monotonic()))
                    c.settimeout(max(0.1, deadline - time.monotonic()))
                    _send_json(c, notice)
                    acked = _recv_json(c).get("kind") == "ack"
            except (OSError, ValueError):
                time.sleep(0.05)
        if not acked:
            unacked.append(peer)
    return unacked


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


def _pure_spec(state):
    """``(spec, leaves)`` from the minimal deterministic flattener over
    dict/list/tuple nests (sorted dict keys, the order of
    ``utils/tree.py``).  The spec is JSON-able nested tuples: the
    structural description the join protocol ships to a cold joiner, which
    has the committed bytes but never saw the state object."""
    leaves = []

    def build(node):
        if isinstance(node, dict):
            return ("d", tuple(sorted(node)),
                    tuple(build(node[k]) for k in sorted(node)))
        if isinstance(node, (list, tuple)):
            kind = "l" if isinstance(node, list) else "t"
            return (kind, len(node), tuple(build(v) for v in node))
        leaves.append(node)
        return ("*",)

    return build(state), leaves


def _spec_from_json(obj):
    """Rebuild a :func:`_pure_spec` spec from its JSON round trip (JSON
    turns every tuple into a list)."""
    if isinstance(obj, list):
        return tuple(_spec_from_json(v) for v in obj)
    return obj


def _unflatten_spec(spec, leaves):
    """The nest a :func:`_pure_spec` spec describes, with ``leaves``."""
    it = iter(leaves)

    def rebuild(node):
        tag = node[0]
        if tag == "*":
            return next(it)
        if tag == "d":
            _, keys, subs = node
            return {k: rebuild(sub) for k, sub in zip(keys, subs)}
        _, _, subs = node
        vals = [rebuild(sub) for sub in subs]
        return vals if tag == "l" else tuple(vals)

    return rebuild(spec)


def _plain_nest(node) -> bool:
    """Whether every container of ``node`` is exactly a dict (of string
    keys), a list or a tuple: what the spec can rebuild (a named tuple or
    an ``OrderedDict`` would come back as another type)."""
    if type(node) is dict:
        return (all(isinstance(k, str) for k in node)
                and all(_plain_nest(v) for v in node.values()))
    if type(node) in (list, tuple):
        return all(_plain_nest(v) for v in node)
    return not isinstance(node, (dict, list, tuple))


def _dtype_name(dtype) -> Optional[str]:
    """A torch dtype by name (``"bfloat16"``), ``None`` for a leaf that was
    not a tensor."""
    return None if dtype is None else str(dtype).split(".", 1)[-1]


def _dtype_of(name: Optional[str]):
    if name is None:
        return None
    import torch

    return getattr(torch, name)


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
    ``host`` and ``port_base`` (the agreement's and the join and control
    listeners' TCP), ``process_id``, ``num_processes`` and optionally
    ``backend`` (gloo), ``timeout`` (the new process group's collective
    timeout), ``agree_port_base`` and ``agree_timeout``; a joiner's
    (:func:`join_and_run`) has no rank yet and names its ``device``.
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
        # set by the elastic loop when THIS rank is shrunk out by a planned
        # drain (the announcer, or a row-mate on a Cartesian drain): run()
        # then returned the state of the forced commit early
        self.drained = False
        # the port's record of each planned boundary: drains (the notice,
        # the forced commit's and the re-bootstrap's seconds) and grows
        # (the poll, the admit, the re-bootstrap, the cold restore); a
        # joiner's own admission in ``joined``
        self.drains: List[dict] = []
        self.grows: List[dict] = []
        self.joined: Optional[dict] = None

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
        dtypes = [dt for _, dt in hosted]
        record = {
            "step": int(step),
            "epoch": current_epoch(),
            "k": k,
            "shard": shard,
            "nbytes": int(len(meta) and sum(m[2] for m in meta)),
            "meta": meta,
            "dtypes": dtypes,
            "unflatten": unflatten,
            # what a cold joiner rebuilds the state with (it never saw the
            # state object): the JSON spec and each leaf's torch dtype by
            # name; computed only when the grow path can use them
            "pure_spec": self._validated_pure_spec(state, leaves),
            "dtype_names": [_dtype_name(dt) for dt in dtypes],
            "placement": table,
            "shards": shards,
        }
        with self._lock:
            self._committed = record
        self.last_commit_s = time.perf_counter() - t0
        _meter("elastic.commits")

    @staticmethod
    def _validated_pure_spec(state, leaves):
        """The JSON-able structural spec for the cold-join description, or
        ``None`` when it cannot describe ``state`` faithfully (a container
        other than a plain dict, list or tuple, or a leaf order that is
        not the flattener's).  A tree walk a commit, so it only runs when
        the grow path that consumes it is on."""
        if not config.elastic_grow():
            return None
        spec, pure_leaves = _pure_spec(state)
        if (len(pure_leaves) != len(leaves)
                or any(a is not b for a, b in zip(pure_leaves, leaves))
                or not _plain_nest(state)):
            return None
        return spec

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

    def can_describe_commit(self) -> bool:
        """Whether the last commit carries a validated structural spec: the
        admission gate.  A world whose state cannot be described admits no
        joiner (rank 0 refuses before any epoch moves, so the refusal is
        symmetric across ranks)."""
        with self._lock:
            rec = self._committed
        return bool(rec) and rec.get("pure_spec") is not None

    def describe_commit(self) -> dict:
        """JSON-able description of the last commit: everything a cold
        joiner needs to rebuild the state from the restore exchange's
        bytes (step, shard geometry, per-leaf meta, structural spec,
        placement; the JAX package's keys, with its values) and each
        leaf's torch dtype by name (``torch_dtypes``, ``None`` for a leaf
        that was not a tensor), and no shard payload: those flow through
        the exchange's cold branch.  Needs a state of plain dict, list and
        tuple nests, committed with ``MPI4JAX_TPU_ELASTIC_GROW`` on."""
        rec = self._require_commit()
        if rec.get("pure_spec") is None:
            raise RuntimeError(
                "describe_commit: the committed state's structure is not "
                "JSON-able (a named tuple, an OrderedDict, non-string keys?) "
                "or MPI4JAX_TPU_ELASTIC_GROW was off at the commit; cold "
                "joins need dict/list/tuple state nests"
            )
        return {
            "step": rec["step"],
            "epoch": rec["epoch"],
            "k": rec["k"],
            "shard": rec["shard"],
            "nbytes": rec["nbytes"],
            "meta": [[list(shape), dtype, nbytes]
                     for shape, dtype, nbytes in rec["meta"]],
            "pure_spec": rec["pure_spec"],
            "placement": [list(holders)
                          for holders in self._rec_placement(rec)],
            "torch_dtypes": list(rec["dtype_names"]),
        }

    def adopt_commit(self, desc: dict) -> None:
        """The cold joiner's half of :meth:`describe_commit`: install a
        commit record with the described geometry and NO shards, so the
        next :meth:`restore` (``force_exchange=True``) contributes zeros
        and receives everything."""
        spec = _spec_from_json(desc["pure_spec"])
        placement = (
            tuple(tuple(int(r) for r in holders)
                  for holders in desc["placement"])
            if desc.get("placement") is not None
            else neighbor_placement(int(desc["k"]), self.redundancy))
        names = desc.get("torch_dtypes") or [None] * len(desc["meta"])
        record = {
            "step": int(desc["step"]),
            "epoch": int(desc["epoch"]),
            "k": int(desc["k"]),
            "shard": int(desc["shard"]),
            "nbytes": int(desc["nbytes"]),
            "meta": [(tuple(shape), str(dtype), int(nbytes))
                     for shape, dtype, nbytes in desc["meta"]],
            "dtypes": [_dtype_of(n) for n in names],
            "unflatten": lambda leaves: _unflatten_spec(spec, leaves),
            "pure_spec": spec,
            "dtype_names": list(names),
            "placement": placement,
            "shards": {},
            "cold": True,
        }
        with self._lock:
            self._committed = record

    def restore(self, failed: Iterable[int] = (), *,
                force_exchange: bool = False):
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
        ``force_exchange=True`` exchanges in a world of one rank too; it
        is the cold-join branch's flag (after a grow every rank, the
        joiners included, runs the exchange; a joiner's adopted commit
        holds no shards, so it contributes zeros and receives everything).
        """
        import numpy as np

        rec = self._require_commit()
        k, shard = rec["k"], rec["shard"]
        plan = plan_from_placement(frozenset(failed), self._rec_placement(rec))
        if rec.get("cold"):
            if self.world_size() == 1:
                raise RuntimeError(
                    "ShardStore.restore: this commit was adopted by a cold "
                    "joiner and holds no shards; it restores only through "
                    "the exchange with the world that committed it")
            _meter("elastic.cold_restores")
        if self.world_size() == 1 and not force_exchange:
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

    def apply_grow(self, added: int) -> None:
        """The JAX package's single-controller grow, where one process
        drives every rank and appends spare devices to its mesh.  The port
        runs one process per rank: the replacement ranks are processes that
        join (:func:`join_and_run`), and a world of several processes grows
        through :meth:`rebootstrap_grow`, so this raises there.  In a world
        of one process there is no process to append: it raises too, after
        checking ``added`` and the grid as :func:`grow_world_mesh` does
        (a 1-D grid, ``added >= 1``)."""
        import torch.distributed as dist

        from ..parallel.mesh import grow_world_mesh

        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            raise RuntimeError(
                "ShardStore.apply_grow is the single-controller grow; this "
                f"world has {dist.get_world_size()} processes, one per rank, "
                "so it grows through ShardStore.rebootstrap_grow (the "
                "elastic loop's admission, under MPI4JAX_TPU_ELASTIC_GROW)")
        grid = self.comm.mesh
        if grid is None:
            raise RuntimeError("elastic grow needs a comm bound to a grid")
        grow_world_mesh(grid, added)

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
        _renumber_origin(rank_map, world)
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

    def rebootstrap_grow(self, added: int, origins=None,
                         comm_uid: Optional[int] = None) -> None:
        """Multi-process grow: tear the revoked process group down and
        initialise one of ``world + added`` processes at the current
        epoch's rendezvous.  Existing ranks keep their numbers (a grow never
        renumbers); the joiners take ``world..world+added-1`` with the
        launch ranks ``origins`` (by default the next ones the counter
        issues).  The grid is 1-D only (joiners append to the end of the
        rank line).  ``comm_uid`` is the uid the new comm takes, the one
        the admit message gave the joiners, so that every rank of the
        grown world matches point-to-point messages in one namespace.  The
        commit gets the identity rank map, so the cold restore's providers
        are the unchanged old ranks."""
        from ..parallel.comm import Comm, resume_uids_at
        from ..parallel.mesh import grow_world_mesh, set_default_mesh

        bs = self._require_bootstrap()
        old = self.comm.mesh
        if old is None:
            raise RuntimeError("elastic grow needs a comm bound to a grid")
        if len(old.shape) != 1:
            raise RuntimeError(
                f"elastic grow needs a 1-D grid (joiners append to the end "
                f"of the rank line); this one is {tuple(old.shape)}")
        world = int(bs["num_processes"])
        if origins is None:
            origins = _issue_origins(world, added)
        axes = self.comm.axes
        self._reinit_distributed(world + int(added), int(bs["process_id"]),
                                 old.device)
        _append_origins(world, origins)
        new_mesh = grow_world_mesh(old, added)
        set_default_mesh(new_mesh)
        if comm_uid is not None:
            resume_uids_at(comm_uid)
        self._comm = Comm(axes, mesh=new_mesh)
        with self._lock:
            if self._committed is not None:
                k = self._committed["k"]
                self._committed["rank_map"] = {r: r for r in range(k)}

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
                 world: Optional[int] = None, added: int = 0,
                 cause: str = "failure") -> int:
    """Revoke the current comm epoch at an elastic boundary.  The boundary
    carries a world *delta*: ranks removed (a failure or a drain) and/or
    ranks added (a join):

    - advance the epoch (every comm of the old one refuses collectives,
      MPX126; every pin refuses its next call, MPX129), recording the
      delta in :func:`epoch_history`;
    - drain the watchdog's in-flight registries (arms from collectives of
      the revoked world must not fire in the recovered job);
    - drop the resilience plan memo (``ops/_base.clear_caches``);
    - journal exactly one ``epoch_change`` telemetry incident.

    Returns the new epoch.
    """
    from ..ops import _base
    from . import watchdog as _wd

    dead = sorted(frozenset(failed))
    new_world = (world - len(dead) + int(added)) if world else None
    if cause == "join":
        detail = (f"admitted {added} replacement rank(s)"
                  + (f" -> world {new_world}" if new_world else ""))
    elif cause == "drain":
        detail = (f"drained rank(s) {dead}"
                  + (f" of {world}" if world else ""))
    else:
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
        start_step: int = 0, commit_every=1, claim_watchdog: bool = True,
        drain_on_sigterm: bool = True):
    """Run ``state = step_fn(state, step, comm)`` for ``steps`` steps,
    surviving rank loss and world churn:

    - on a :class:`RankFailure` (raised by the step, posted by the claimed
      watchdog, or classified from a distributed death rattle) the loop
      agrees on the failed set with the surviving peers, revokes the
      epoch, shrinks the world (a re-bootstrap over the survivors, by rank
      or by whole grid row or column under
      ``MPI4JAX_TPU_ELASTIC_FAIL_UNIT``), restores the last committed
      state, and continues on ``k - f`` ranks from the committed step;
    - on a drain request (:func:`request_drain`: a SIGTERM, the
      ``preempt`` fault verb) the loop forces an early commit at the next
      step boundary and executes a planned shrink: peers are notified
      with acks, no watchdog expiry fires, no agreement runs, and exactly
      one ``drain`` incident is journalled.  A rank shrunk away (the
      leaver, or a row-mate on a Cartesian drain) destroys its process
      group and returns its state with ``store.drained`` set;
    - with ``MPI4JAX_TPU_ELASTIC_GROW`` on, replacement processes that
      contacted rank 0 (:func:`request_join`, :func:`join_and_run`) are
      admitted at the next commit boundary: the epoch advances with a
      positive world delta, every process re-bootstraps at ``k + j``, and
      the committed state streams to the joiners through the cold-join
      restore.  Every commit boundary then costs one tiny SUM
      ``allreduce`` (the poll).

    ``step_fn`` takes the CURRENT comm: after any boundary it is a new
    (resized, new-epoch) comm.  ``commit_every`` bounds the recovery
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
    waiting in Python.  ``drain_on_sigterm=True`` installs, in the main
    thread of a world of several processes, a SIGTERM handler that turns
    a preemption notice into a drain request.  Both handlers are
    installed inside the loop's ``try`` and restored in its ``finally``.
    """
    return _run_loop(step_fn, state, store, steps=steps,
                     start_step=start_step, commit_every=commit_every,
                     claim_watchdog=claim_watchdog,
                     drain_on_sigterm=drain_on_sigterm)


def _run_loop(step_fn, state, store: ShardStore, *, steps: int,
              start_step: int, commit_every, claim_watchdog: bool,
              drain_on_sigterm: bool, auto_warm: bool = False,
              anchor: Optional[int] = None):
    """:func:`run`'s loop.  A joiner enters it at the admission step with
    the world's commit cadence: ``anchor``, the step the world's commits
    count from (commits land where ``(step - anchor) % commit_every`` is
    0), and ``auto_warm=True`` when the world still measured
    ``commit_every='auto'`` (the untimed first step is skipped, so the
    joiner locks the interval in at the world's boundary)."""
    from . import watchdog as _wd

    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    auto_commit: Optional[dict] = None
    if isinstance(commit_every, str):
        if commit_every != "auto":
            raise ValueError(
                f"commit_every must be an int >= 1 or 'auto', got "
                f"{commit_every!r}"
            )
        auto_commit = {"step_s": None, "commit_s": None,
                       "warm": bool(auto_warm)}
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
    anchor = start_step if anchor is None else int(anchor)

    from ..aot.invalidation import StaleProgramError as _Stale

    claimed = False
    prev_handler = prev_fallback = prev_sigterm = None
    servers: dict = {}
    try:
        # setup that can fail (socket binds, the bootstrap dict) runs
        # inside the try: the finally restores both handlers whatever
        # happens
        if claim_watchdog:
            prev_handler = _wd._registry.on_timeout
            prev_fallback = _wd._force_fallback
            claimed = True
            _wd.set_on_timeout(_claimed_on_timeout)
            _wd.force_python_fallback(True)
            _install_interrupt()
        if drain_on_sigterm and store.multiprocess():
            prev_sigterm = install_preemption_handler()
        _restart_elastic_servers(servers, store)
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
                if (step - anchor) % commit_every == 0 or step == steps:
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
                # the health tick before the boundary actions: a suspect
                # RankFailure raised there recovers like any peer death
                _health_boundary(store, step, committed)
                outcome = _boundary_actions(
                    store, step, steps, state, committed, anchor,
                    commit_every, servers, auto=auto_commit is not None)
                if outcome is not None:
                    kind, step, state = outcome
                    if kind == "leave":
                        return state
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
                _restart_elastic_servers(servers, store)
        return state
    finally:
        _stop_elastic_servers(servers)
        if claimed:
            _uninstall_interrupt()
            _wd.set_on_timeout(prev_handler)
            _wd.force_python_fallback(prev_fallback)
        _restore_sigterm(prev_sigterm)


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


# ---------------------------------------------------------------------------
# boundary control: planned reconfiguration between steps
# ---------------------------------------------------------------------------


def _record(store, name: str, rec: dict) -> None:
    """Append ``rec`` to the store's list ``name`` where it keeps one (a
    scripted store may not)."""
    log = getattr(store, name, None)
    if isinstance(log, list):
        log.append(rec)


def _restart_elastic_servers(servers: dict, store: ShardStore) -> None:
    """(Re)bind the epoch-scoped listeners: every rank of a world of
    several processes runs a control listener (drain notices); rank 0 also
    runs the join listener when the grow flag is on.  A failed bind
    degrades silently: the listeners serve the PLANNED paths, and the
    failure path never needs them."""
    _stop_elastic_servers(servers)
    if not store.multiprocess():
        return
    bs = store.bootstrap
    try:
        host, pb = bs["host"], int(bs["port_base"])
        me = int(bs["process_id"])
    except (KeyError, TypeError, ValueError):
        return
    epoch = current_epoch()
    try:
        servers["control"] = _ControlServer(host, control_port(pb, me, epoch))
    except (OSError, ValueError):
        servers["control"] = None
    if me == 0 and config.elastic_grow():
        try:
            servers["join"] = _JoinServer(host, join_port(pb, epoch))
            _publish_join_port(bs.get("rendezvous"), host,
                               join_port(pb, epoch), epoch)
        except OSError:
            servers["join"] = None


def _stop_elastic_servers(servers: dict) -> None:
    for srv in servers.values():
        if srv is not None:
            srv.stop()
    servers.clear()


def _boundary_actions(store: ShardStore, step: int, steps: int, state,
                      committed: bool, start_step: int, commit_every: int,
                      servers: dict, *, auto: bool = False):
    """Planned world changes at a step boundary, in priority order: execute
    a scheduled drain (ours or a peer's), then admit pending joiners
    (commit boundaries only).  ``start_step`` is the step the loop's
    commits count from, and ``auto`` says it still measures
    ``commit_every='auto'``: a joiner takes both, so that it commits (and
    polls for joins) at the world's boundaries.  Returns ``None`` (nothing to do), ``("continue", step,
    state)`` (the world changed, keep looping), or ``("leave", step,
    state)`` (this rank was drained out)."""
    mine = take_pending_drain()
    if mine is not None and store.multiprocess():
        bs = store.bootstrap
        my_rank = int(bs["process_id"])
        leaver = my_rank if mine["rank"] is None else int(mine["rank"])
        scheduled = peek_peer_drain()
        if leaver == my_rank and scheduled is None:
            # announce our departure: boundary = the NEXT step boundary,
            # acks collected before anyone steps toward it, so no peer can
            # race past the boundary into a collective we never enter
            boundary = step + 1
            at, t0 = time.time(), time.perf_counter()
            unacked = notify_drain(bs["host"], int(bs["port_base"]), my_rank,
                                   int(bs["num_processes"]), boundary,
                                   grace=mine["grace"])
            _record(store, "drains", {
                "notice": True, "at": at, "boundary": boundary,
                "notify_s": time.perf_counter() - t0, "unacked": unacked})
            mark_comm_draining(store.comm, boundary)
            _post_peer_drain(my_rank, boundary)
            mine = None
        elif leaver == my_rank:
            # a drain is already scheduled: ours (a repeated notice, as a
            # ``preempt`` clause posts at every call after it fired) is
            # announced once; another rank's executes first, and ours is
            # announced in the world after it
            if int(scheduled["rank"]) != my_rank:
                request_drain(mine["grace"])
            mine = None
        else:
            mine = {"rank": leaver, "grace": mine["grace"]}
    if mine is not None:
        # a drain of a named rank, executed at THIS boundary (a scripted
        # store's drills, or every process of a world asking alike)
        if mine["rank"] is None:
            raise RuntimeError(
                "request_drain() without a rank needs a multi-process "
                "world (a single controller cannot leave its own job); "
                "pass rank= to drain a simulated rank"
            )
        return _execute_drain(store, step, state, committed,
                              int(mine["rank"]), servers)
    peer = peek_peer_drain()
    if peer is not None and step >= int(peer["boundary"]):
        notice_at = _peer_drain_at[0] if _peer_drain_at else None
        take_peer_drain()
        return _execute_drain(store, step, state, committed,
                              int(peer["rank"]), servers,
                              notice_at=notice_at)
    if committed and step < steps:
        t0 = time.perf_counter()
        joins = _poll_joins(store)
        poll_s = time.perf_counter() - t0
        # never admit at a boundary with a drain already scheduled: the
        # joiner would miss the delivered notice and desynchronize at the
        # leave boundary.  Every old rank sees the same pending notice
        # here (the leaver collects acks BEFORE it enters the poll), so
        # the deferral is symmetric; the joiners stay parked.
        if joins and peek_peer_drain() is None:
            return _execute_grow(store, step, state, committed, joins,
                                 servers, commit_every=commit_every,
                                 anchor=start_step, auto=auto, poll_s=poll_s)
    return None


def _execute_drain(store: ShardStore, step: int, state, committed: bool,
                   leaver: int, servers: dict, *,
                   notice_at: Optional[float] = None):
    """The planned shrink at the leave boundary: force the early commit,
    widen the removal to the declared fail unit, and either leave (this
    rank is the leaver or shrunk out with it: its process group is
    destroyed) or rebuild the world without the leavers.  No agreement
    round (the departure is announced, not suspected), no restore (every
    survivor's state is live), no majority guard (a planned drain cannot
    split-brain), exactly one ``drain`` incident per process."""
    from . import watchdog as _wd

    at, t0 = time.time(), time.perf_counter()
    with _wd.suspend_expiries():
        if not committed:
            store.commit(step, state)
        t_commit = time.perf_counter()
        comm = store.comm
        mesh = getattr(comm, "mesh", None)
        mesh_shape = (tuple(mesh.shape) if mesh is not None
                      else (int(comm.world_size()),))
        unit = config.elastic_fail_unit()
        removed = expand_fail_unit({leaver}, mesh_shape, unit)
        world = int(store.bootstrap.get("num_processes")
                    or comm.world_size())
        me = (int(store.bootstrap["process_id"])
              if store.multiprocess() else None)
        _meter("elastic.drains")
        _incident(
            "elastic.drain_incidents", "drain", me if me is not None else 0,
            f"rank {leaver} drained at step {step} (removed "
            f"{sorted(removed)} of {world}, fail_unit={unit})",
        )
        seal_drained_comm(comm)
        rec = {"leaver": leaver, "step": step, "removed": sorted(removed),
               "world": world, "notice_at": notice_at, "boundary_at": at,
               "commit_s": t_commit - t0, "forced": not committed}
        if me is not None and me in removed:
            # we are leaving (the announcer, or a row-mate shrunk out with
            # it): the state as of the forced commit is the result
            store.drained = True
            _teardown_process_group()
            _record(store, "drains", dict(rec, left=True))
            return "leave", step, state
        revoke_epoch(removed, rank=me if me is not None else 0,
                     world=world, cause="drain")
        if store.multiprocess():
            store.rebootstrap(removed, unit)
        else:
            store.apply_shrink(removed, unit)
        _restart_elastic_servers(servers, store)
        _record(store, "drains", dict(
            rec, left=False, rebootstrap_s=time.perf_counter() - t_commit))
    return "continue", step, state


def _poll_joins(store: ShardStore) -> int:
    """How many joiners to admit at this boundary.  A scripted store (one
    process): the pending-join queue.  A world of several processes (grow
    flag on): one tiny SUM ``allreduce`` of every rank's pending count
    (rank 0's join listener parks them), so every rank learns the same
    delta at the same boundary."""
    if not store.multiprocess():
        return pending_join_count()
    if not config.elastic_grow():
        return 0
    import torch

    from ..ops import SUM, allreduce

    comm = store.comm
    me = int(store.bootstrap["process_id"])
    pending = pending_join_count()
    if pending and me == 0 and not store.can_describe_commit():
        # the committed state cannot be described to a joiner: refuse
        # admission here, before any epoch moves, so every rank sees 0
        # and the job keeps training instead of dying mid-admission
        _meter("elastic.joins_refused")
        pending = 0
    mine = torch.tensor([pending], dtype=torch.int32, device=comm.device)
    out, _ = allreduce(mine, op=SUM, comm=comm)
    joins = int(out[0])
    if not 0 <= joins <= config.elastic_port_span():
        # a sum no pending counts make: the ranks entered different
        # collectives here (their boundaries diverged)
        raise RuntimeError(
            f"the join poll read {joins} pending joiners: the ranks are not "
            "at the same boundary")
    return joins


def _execute_grow(store: ShardStore, step: int, state, committed: bool,
                  joins: int, servers: dict, *, commit_every: int = 1,
                  anchor: int = 0, auto: bool = False, poll_s: float = 0.0):
    """Admit ``joins`` replacement ranks at this commit boundary: advance
    the epoch with a positive world delta, issue the joiners' launch
    ranks (the same on every rank), send each parked joiner its admit
    message (rank, world, the commit's description, its launch rank, the
    comm uid and the commit interval), re-bootstrap at ``k + joins``, and
    run the cold-join restore so every rank, the joiners included, leaves
    the boundary with the committed state."""
    from ..parallel.comm import next_uid
    from . import watchdog as _wd

    t0 = time.perf_counter()
    with _wd.suspend_expiries():
        if not committed:
            store.commit(step, state)
        comm = store.comm
        world = int(store.bootstrap.get("num_processes")
                    or comm.world_size())
        me = (int(store.bootstrap["process_id"])
              if store.multiprocess() else 0)
        _meter("elastic.joins", joins)
        _incident(
            "elastic.join_incidents", "join", me,
            f"admitting {joins} replacement rank(s) at step "
            f"{store.committed_step}: world {world} -> {world + joins}",
        )
        revoke_epoch((), rank=me, world=world, added=joins, cause="join")
        if store.multiprocess():
            origins = _issue_origins(world, joins)
            uid = next_uid()
            if me == 0:
                pending = _take_pending_joins()
                # a joiner that arrived after the poll stays parked for the
                # NEXT boundary (the polled count is what every rank agreed
                # to admit)
                if len(pending) > joins:
                    with _join_lock:
                        _pending_joins[0:0] = pending[joins:]
                desc = store.describe_commit()
                grown = ([origin_rank(r) for r in range(world)]
                         + list(origins))
                for i, j in enumerate(pending[:joins]):
                    admit = {
                        "kind": "admit",
                        "epoch": current_epoch(),
                        "process_id": world + i,
                        "num_processes": world + joins,
                        "step": store.committed_step,
                        "commit": desc,
                        "axes": list(comm.axes),
                        "origin": origins[i],
                        "origins": grown,
                        "launch_ranks_issued": _origins_issued,
                        "comm_uid": uid,
                        "commit_every": int(commit_every),
                        "commit_anchor": int(anchor),
                        "auto_commit": bool(auto),
                    }
                    conn = j.get("conn")
                    if conn is not None:
                        try:
                            _send_json(conn, admit)
                        except OSError:
                            pass
                        finally:
                            conn.close()
            t_admit = time.perf_counter()
            store.rebootstrap_grow(joins, origins=origins, comm_uid=uid)
            t_boot = time.perf_counter()
            new_step, new_state = store.restore(force_exchange=True)
            _block_on(new_state)
        else:
            _take_pending_joins()
            t_admit = time.perf_counter()
            store.apply_grow(joins)
            t_boot = time.perf_counter()
            new_step, new_state = store.restore()
        t_restored = time.perf_counter()
        _restart_elastic_servers(servers, store)
        _record(store, "grows", {
            "added": joins, "step": new_step, "epoch": current_epoch(),
            "world": world + joins, "poll_s": poll_s,
            "admit_s": t_admit - t0, "rebootstrap_s": t_boot - t_admit,
            "restore_s": t_restored - t_boot})
        _meter("elastic.resumes")
    return "continue", new_step, new_state


class BoundaryControl:
    """Planned-reconfiguration polling for a loop other than :func:`run`.

    :func:`run` owns a fixed step budget; a loop that does not (a server,
    whose iteration count depends on traffic) still needs the same
    between-step semantics: a SIGTERM or preemption notice becomes a drain
    request, the leaver announces its boundary with acks, every rank
    executes the planned shrink at that boundary (one ``drain`` incident,
    no watchdog expiry, no agreement), and pending joiners are admitted at
    committed boundaries.  This wraps the helper :func:`run` drives plus
    the listeners' lifecycle::

        with BoundaryControl(store) as bc:
            while serving:
                ...one step...
                outcome = bc.poll(step, state, committed=True)
                if outcome is not None:
                    kind, step, state = outcome
                    if kind == "leave":
                        break            # we drained out
                    rebuild_programs()   # the world changed

    ``poll`` returns ``None`` (nothing happened), ``("continue", step,
    state)`` (the world changed: the store's comm is rebuilt), or
    ``("leave", step, state)`` (this rank was drained out;
    ``store.drained`` is set)."""

    def __init__(self, store: ShardStore, *, drain_on_sigterm: bool = True):
        self.store = store
        self.servers: dict = {}
        self._prev_sigterm = None
        self._drain_on_sigterm = drain_on_sigterm
        self._entered = False

    def __enter__(self) -> "BoundaryControl":
        self._entered = True
        try:
            if self._drain_on_sigterm and self.store.multiprocess():
                self._prev_sigterm = install_preemption_handler()
            _restart_elastic_servers(self.servers, self.store)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def poll(self, step: int, state, *, committed: bool = True):
        """Run the boundary actions for step ``step`` (drain execution,
        join admission).  ``committed=False`` makes a drain force-commit
        ``state`` before the shrink (pass True when the caller's committed
        state is already current)."""
        return _boundary_actions(self.store, step, step + 1, state,
                                 committed, 0, 1, self.servers)

    def __exit__(self, *exc) -> bool:
        if not self._entered:
            return False
        self._entered = False
        _stop_elastic_servers(self.servers)
        _restore_sigterm(self._prev_sigterm)
        self._prev_sigterm = None
        return False


def join_and_run(step_fn, store: ShardStore, *, steps: int,
                 commit_every=1, claim_watchdog: bool = True,
                 drain_on_sigterm: bool = True, join_timeout: float = 300.0):
    """The replacement process's entry point: contact the running world's
    rank 0 (at the join listener it names beside the world's ``file://``
    rendezvous), wait to be admitted at a commit boundary, adopt the admitted epoch, rank and
    launch rank, join the world's process group at the epoch's rendezvous
    (``init_distributed`` at ``rendezvous_for(bootstrap["rendezvous"],
    epoch)`` on the bootstrap's ``device``), receive the committed state
    through the cold-join restore (we contribute zeros, the survivors'
    shards sum to everything), and enter :func:`run` at the committed step
    with the world's commit cadence: its interval and the step its commits
    count from (``commit_every`` is used only where the admit names no
    interval).  Returns the final state, as :func:`run` does.

    ``store.bootstrap`` needs ``rendezvous``, ``host`` and ``port_base``
    (those of the world: the rendezvous names rank 0's join listener), and takes ``device``, ``backend``, ``timeout``,
    ``agree_port_base`` and ``agree_timeout`` as :class:`ShardStore` does.
    A join fails loudly: no admission within ``join_timeout`` or a failed
    rendezvous raises.  With the health plane armed it refuses before
    contacting the world: the detector's boundary exchange counts the
    boundaries since its process started, which a joiner cannot match."""
    from ..parallel.comm import Comm, resume_uids_at
    from ..parallel.mesh import (init_distributed, make_world_mesh,
                                 set_default_mesh)
    from ..telemetry import health as _health

    bs = store.bootstrap
    for key in ("rendezvous", "host", "port_base"):
        if key not in bs:
            raise RuntimeError(
                "join_and_run needs ShardStore(bootstrap={'rendezvous', "
                f"'host', 'port_base'}}); missing {key!r}"
            )
    if _health.armed():
        raise RuntimeError(
            "join_and_run: the health plane is armed (MPI4JAX_TPU_HEALTH=on); "
            "its detector exchanges at the boundaries its process counted "
            "since it started, which a joiner cannot line up with the "
            "world's: start the replacement with the health plane off"
        )
    # the device's context before the knock, not inside the world's
    # re-bootstrap, which waits for this process
    from ..parallel.mesh import resolve_device

    dev0 = resolve_device(bs.get("device"))
    if dev0.type == "cuda":
        import torch

        if dev0.index is not None:
            torch.cuda.set_device(dev0)
        torch.empty(1, device=dev0)
    t0 = time.perf_counter()
    admit = request_join(bs["rendezvous"], timeout=join_timeout)
    t_admit = time.perf_counter()
    _set_epoch(int(admit["epoch"]))
    bs["process_id"] = int(admit["process_id"])
    bs["num_processes"] = int(admit["num_processes"])
    _adopt_origins(admit.get("origins"), admit.get("launch_ranks_issued"))
    dev = init_distributed(
        bs.get("backend", "gloo"),
        init_method=rendezvous_for(bs["rendezvous"], current_epoch()),
        world_size=bs["num_processes"], rank=bs["process_id"],
        device=bs.get("device"), timeout=float(bs.get("timeout", 300.0)))
    axes = tuple(admit.get("axes") or ()) or None
    mesh = make_world_mesh((int(bs["num_processes"]),), axes, device=dev)
    set_default_mesh(mesh)
    if admit.get("comm_uid") is not None:
        resume_uids_at(int(admit["comm_uid"]))
    store._comm = Comm(mesh.axes, mesh=mesh)
    store.adopt_commit(admit["commit"])
    _incident(
        "elastic.join_incidents", "join", int(bs["process_id"]),
        f"cold-joined epoch {current_epoch()} as rank "
        f"{bs['process_id']} of {bs['num_processes']} at step "
        f"{admit['step']}",
    )
    t_boot = time.perf_counter()
    step, state = store.restore(force_exchange=True)
    _block_on(state)
    store.joined = {
        "step": step, "epoch": current_epoch(),
        "process_id": int(bs["process_id"]), "origin": admit.get("origin"),
        "wait_s": t_admit - t0, "rebootstrap_s": t_boot - t_admit,
        "restore_s": time.perf_counter() - t_boot,
        "commit_every": admit.get("commit_every"),
        "auto_commit": admit.get("auto_commit")}
    _meter("elastic.resumes")
    auto_warm = False
    if admit.get("auto_commit"):
        commit_every, auto_warm = "auto", True
    elif admit.get("commit_every") is not None:
        commit_every = int(admit["commit_every"])
    return _run_loop(step_fn, state, store, steps=steps, start_step=step,
                     commit_every=commit_every,
                     claim_watchdog=claim_watchdog,
                     drain_on_sigterm=drain_on_sigterm, auto_warm=auto_warm,
                     anchor=admit.get("commit_anchor"))


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
    _record(store, "recoveries", {
        "failed": sorted(failed), "step": step, "epoch": current_epoch(),
        "detect_s": detect_s,
        "agree_s": t_agreed - t0, "rebootstrap_s": t_boot - t_agreed,
        "restore_s": t_restored - t_boot,
    })
    _meter("elastic.resumes")
    return step, state
