"""Deterministic chaos drills for the elastic control plane.

PyTorch counterpart of ``mpi4jax_tpu/resilience/drill.py`` (pure: numpy
only, no process group, no sockets, no clocks).  A drill simulates a
k-rank world in-process (one rank-pinned :class:`~.elastic.ShardStore`
per simulated rank, the pure agreement models as the failure-detection
fabric), scripts a kill pattern and asserts the two invariants the
control plane owes its operator:

- **agreement**: every survivor commits the SAME failed set, equal to
  the actually-killed ranks, and the coordinator-mediated star reaches
  exactly the pure ``gossip_agreement`` fixpoint with O(k) connections;
- **restore**: the committed state reassembles bit-identically from the
  surviving replicas (and, for the host-row pattern, provably CANNOT
  under the neighbor placement: the negative control that makes the
  stripe's guarantee falsifiable).

Patterns (:data:`PATTERNS`):

``single``        one mid-world rank dies.
``host-row``      every rank of one host dies at once: the pattern
                  neighbor placement cannot survive and the stripe must.
``coordinator``   rank 0 (the agreement coordinator) dies: agreement
                  degrades to peer gossip and restore still completes.
``double``        cascading double fault: one rank dies, the world
                  shrinks and re-commits, then a second rank dies in the
                  shrunken world.

The metrics are all-integer and deterministic: ``drill_matrix`` returns
the JAX package's list on the same arguments
(``tests/test_torch_drill.py``).  The runtime transport (real TCP
agreement rounds) is tested on localhost threads; the drills model its
cost analytically, so a 64-rank matrix costs milliseconds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .elastic import (
    RankFailure,
    ShardStore,
    coordinator_agreement,
    gossip_agreement,
    neighbor_placement,
    plan_from_placement,
    reassemble_from_stores,
)

__all__ = [
    "PATTERNS",
    "default_counts",
    "links_for",
    "kill_set",
    "agreement_connections",
    "run_drill",
    "drill_matrix",
]

PATTERNS = ("single", "host-row", "coordinator", "double")

# gossip rounds the TCP runtime form uses (exchange_suspects default)
_GOSSIP_ROUNDS = 2


def default_counts(k: int) -> Tuple[int, ...]:
    """The drill topology for ``k`` simulated ranks: the squarest
    uniform host split (8 -> 2 hosts x 4, 16 -> 4 x 4, 64 -> 8 x 8) —
    hosts of several ranks each, so a host-row kill is a genuinely
    correlated multi-rank loss."""
    if k < 1:
        raise ValueError(f"need at least one rank, got k={k}")
    hosts = max(1, int(k ** 0.5))
    while k % hosts:
        hosts -= 1
    return (k // hosts,) * hosts


def links_for(world: int, dead: Iterable[int]) -> List[List[bool]]:
    """The link matrix after ``dead`` die: every link touching a dead
    rank is down, every survivor pair healthy (partition-free — the
    partition cases are pinned directly on the pure models)."""
    gone = frozenset(dead)
    return [[i != j and i not in gone and j not in gone
             for j in range(world)] for i in range(world)]


def kill_set(pattern: str, k: int,
             counts: Sequence[int]) -> Tuple[int, ...]:
    """The ranks the FIRST wave of ``pattern`` kills (the ``double``
    pattern's second wave is derived inside :func:`run_drill` from the
    shrunken world)."""
    if pattern not in PATTERNS:
        raise ValueError(f"unknown drill pattern {pattern!r}; "
                         f"expected one of {PATTERNS}")
    if pattern == "single" or pattern == "double":
        return (k // 2,)
    if pattern == "coordinator":
        return (0,)
    # host-row: every rank of host 1 (host 0 keeps the coordinator)
    if len(counts) < 2:
        raise ValueError(
            f"host-row drill needs >= 2 hosts, got counts {tuple(counts)}")
    start = counts[0]
    return tuple(range(start, start + counts[1]))


def agreement_connections(world: int, dead: Iterable[int],
                          mode: str, coordinator: int = 0) -> int:
    """Analytic TCP connection count of one agreement round — the cost
    model the O(k) acceptance assertion pins.

    ``coordinator`` mode with a live coordinator: one report connection
    per non-coordinator survivor (the verdict rides the same socket
    back).  A dead coordinator costs every survivor one failed probe,
    then the full peer-gossip fallback.  ``gossip`` mode: every round,
    every survivor dials every other rank (the all-pairs O(k²) the star
    exists to replace)."""
    gone = frozenset(dead)
    s = world - len(gone)
    gossip = _GOSSIP_ROUNDS * s * (world - 1)
    if mode == "gossip":
        return gossip
    if mode != "coordinator":
        raise ValueError(f"unknown agreement mode {mode!r}")
    if coordinator in gone:
        return s + gossip  # s failed probes, then the fallback
    return s - 1


class _FixedComm:
    """The world-size stub rank-pinned simulated stores dial."""

    def __init__(self, k: int):
        self._k = k

    def world_size(self) -> int:
        return self._k


def _drill_state(seed: int = 0) -> dict:
    """The deterministic committed state: non-divisible byte sizes (the
    padding path) and two dtypes, same on every simulated rank."""
    import numpy as np

    return {
        "w": (np.arange(1000, dtype=np.float64) + seed),
        "b": (np.arange(333, dtype=np.float32) * 3 + seed),
        "step_scale": np.float32(1.5 + seed),
    }


def _states_equal(a: dict, b: dict) -> bool:
    import numpy as np

    return (sorted(a) == sorted(b)
            and all(np.array_equal(a[key], b[key]) for key in a))


def _build_stores(k: int, counts: Sequence[int], redundancy: int,
                  placement: str) -> Dict[int, ShardStore]:
    comm = _FixedComm(k)
    return {
        r: ShardStore(comm, redundancy=redundancy, rank=r,
                      topology=tuple(counts), placement=placement)
        for r in range(k)
    }


def _check_agreement(world: int, dead: frozenset,
                     coordinator: int = 0) -> None:
    """Assert both pure agreement models converge every survivor to
    exactly ``dead``.  Detection is deliberately asymmetric — only the
    lowest survivor names the dead ranks, everyone else reports the
    empty "something died but unnamed" set — so the drill exercises
    propagation, not just echo."""
    survivors = sorted(set(range(world)) - dead)
    observer = survivors[0]
    suspects = {r: (sorted(dead) if r == observer else [])
                for r in survivors}
    links = links_for(world, dead)
    gossip = gossip_agreement(suspects, links)
    coord = coordinator_agreement(suspects, links,
                                  coordinator=coordinator)
    for r in survivors:
        if gossip[r] != dead:
            raise AssertionError(
                f"gossip agreement diverged: survivor {r} committed "
                f"{sorted(gossip[r])}, expected {sorted(dead)}")
        if coord[r] != gossip[r]:
            raise AssertionError(
                f"coordinator agreement != gossip fixpoint at survivor "
                f"{r}: {sorted(coord[r])} vs {sorted(gossip[r])}")


def _restore_metrics(stores: Dict[int, ShardStore],
                     dead: frozenset) -> Dict[int, int]:
    """Byte accounting of one restore wave, from the commit geometry."""
    rec = next(s for r, s in stores.items()
               if r not in dead)._require_commit()
    k, shard = rec["k"], rec["shard"]
    repair_shards = sorted(s for s in range(k) if s in dead)
    survivors = k - len(dead)
    return {
        "state_bytes": int(rec["nbytes"]),
        "shard_bytes": int(shard),
        "repair_shards": len(repair_shards),
        "repair_bytes": len(repair_shards) * int(shard),
        "repair_bytes_per_survivor":
            (len(repair_shards) * int(shard) + survivors - 1) // survivors,
    }


def run_drill(pattern: str, k: int, *, redundancy: int = 1,
              counts: Optional[Sequence[int]] = None,
              placement: str = "stripe") -> dict:
    """Run one kill pattern over ``k`` simulated ranks and return the
    metrics dict (all-integer, deterministic — safe to commit).

    Raises ``AssertionError`` when an invariant breaks: agreement
    divergence, coordinator/gossip fixpoint mismatch, O(k) connection
    budget blown, non-bit-identical restore — or, for ``host-row``
    under the default stripe, when the NEGATIVE control unexpectedly
    passes (neighbor placement surviving the host row would mean the
    drill lost its teeth)."""
    counts = tuple(counts) if counts is not None else default_counts(k)
    if sum(counts) != k:
        raise ValueError(
            f"topology {counts} covers {sum(counts)} ranks, expected {k}")
    stores = _build_stores(k, counts, redundancy, placement)
    state0 = _drill_state()
    for store in stores.values():
        store.commit(0, state0)

    waves: List[frozenset] = [frozenset(kill_set(pattern, k, counts))]
    metrics = {
        "pattern": pattern,
        "k": k,
        "topology": list(counts),
        "redundancy": redundancy,
        "placement": placement,
        "killed": sorted(waves[0]),
        "epochs": 1,
    }

    coordinator = 0
    dead = waves[0]
    _check_agreement(k, dead, coordinator)
    conns = agreement_connections(k, dead, "coordinator", coordinator)
    if coordinator not in dead and conns > k:
        raise AssertionError(
            f"coordinator agreement used {conns} connections at k={k} — "
            "the O(k) star budget is blown")
    metrics["agreement"] = {
        "coordinator_connections": conns,
        "gossip_connections":
            agreement_connections(k, dead, "gossip", coordinator),
    }

    if pattern == "host-row" and placement == "stripe" \
            and redundancy >= 1 and redundancy < counts[1]:
        # negative control: the same kill under neighbor placement must
        # be unrecoverable (a contiguous block wider than the ring depth
        # wipes some shard's whole replica set)
        try:
            plan_from_placement(dead, neighbor_placement(k, redundancy))
        except RankFailure:
            metrics["neighbor_unrecoverable"] = True
        else:
            raise AssertionError(
                f"neighbor placement survived the host-row kill "
                f"{sorted(dead)} at k={k} — the drill's negative control "
                "lost its teeth")

    step, restored = reassemble_from_stores(stores, dead)
    if step != 0 or not _states_equal(state0, restored):
        raise AssertionError(
            f"restore after {pattern} kill {sorted(dead)} was not "
            "bit-identical to the committed state")
    metrics["restore"] = _restore_metrics(stores, dead)

    if pattern == "double":
        # wave 2: shrink to the survivors, re-commit the restored state,
        # then fail again in the SHRUNKEN world — the cascade that
        # catches placement tables stale from the old world size
        k2 = k - len(dead)
        survivors = sorted(set(range(k)) - dead)
        # hosts keep their surviving members (the dead rank's host just
        # gets smaller) — per-host counts of the compacted world
        host_of = [h for h, c in enumerate(counts) for _ in range(c)]
        counts2: List[int] = [0] * len(counts)
        for r in survivors:
            counts2[host_of[r]] += 1
        counts2 = [c for c in counts2 if c]
        stores2 = _build_stores(k2, counts2, redundancy, placement)
        for store in stores2.values():
            store.commit(1, restored)
        dead2 = frozenset({k2 // 2 if k2 // 2 != coordinator else k2 - 1})
        _check_agreement(k2, dead2, coordinator)
        conns2 = agreement_connections(k2, dead2, "coordinator",
                                       coordinator)
        if conns2 > k2:
            raise AssertionError(
                f"coordinator agreement used {conns2} connections at "
                f"k={k2} (wave 2) — the O(k) star budget is blown")
        step2, restored2 = reassemble_from_stores(stores2, dead2)
        if step2 != 1 or not _states_equal(state0, restored2):
            raise AssertionError(
                "restore after the cascading second fault was not "
                "bit-identical to the committed state")
        metrics["epochs"] = 2
        metrics["wave2"] = {
            "k": k2,
            "topology": counts2,
            "killed": sorted(dead2),
            "coordinator_connections": conns2,
            "restore": _restore_metrics(stores2, dead2),
        }

    metrics["recovered"] = True
    return metrics


def drill_matrix(ks: Sequence[int] = (8, 16, 64),
                 patterns: Sequence[str] = PATTERNS, *,
                 redundancy: int = 1) -> List[dict]:
    """The full drill matrix: every pattern at every world size.
    Deterministic: two runs return identical lists."""
    return [run_drill(p, k, redundancy=redundancy)
            for k in ks for p in patterns]
