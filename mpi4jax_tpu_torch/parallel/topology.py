"""The host-topology model: where ranks live (the pure half).

PyTorch counterpart of the pure half of
``mpi4jax_tpu/parallel/topology.py`` (without ``mesh_topology``, whose
host labels come from the devices of a multi-host mesh): the
:class:`Topology` of a flat rank space (each rank's canonical host), the
host span of a group and the link class of a rank pair, which the cost pass (``analysis/cost.py``) prices
its collectives by.  A topology comes from the ``MPI4JAX_TPU_TOPOLOGY``
override (``<hosts>x<ranks_per_host>`` or per-host counts ``3,5``) when
its rank count matches the comm's world.  The port's ranks are processes
of one host (``parallel/launch.py``): without the override there is no
host partition, :func:`derive_world_topology` returns ``None`` and every
link is ``ici``, the JAX package's flat-fallback convention.  The
hierarchical lowerings that read a topology in the JAX package
(``ops/_hierarchy.py``, ``ops/_algos.py``) are not ported (ROADMAP,
Blocked).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..utils import config


def canonical_labels(raw: Sequence) -> Tuple[int, ...]:
    """Renumber host labels by first appearance: ``(7, 7, 3)`` ->
    ``(0, 0, 1)``."""
    seen: dict = {}
    out = []
    for x in raw:
        if x not in seen:
            seen[x] = len(seen)
        out.append(seen[x])
    return tuple(out)


class Topology:
    """The static host partition of a flat rank space: ``host_of_rank[r]``
    is the canonical host of flat rank ``r`` (row-major over the comm's
    axes, the order ``Comm.Get_rank`` defines)."""

    __slots__ = ("host_of_rank",)

    def __init__(self, host_of_rank: Sequence[int]):
        self.host_of_rank = canonical_labels(host_of_rank)

    @property
    def num_hosts(self) -> int:
        return len(set(self.host_of_rank)) if self.host_of_rank else 0

    @property
    def ranks_per_host(self) -> Tuple[int, ...]:
        counts: dict = {}
        for h in self.host_of_rank:
            counts[h] = counts.get(h, 0) + 1
        return tuple(counts[h] for h in sorted(counts))

    def fingerprint(self) -> tuple:
        return self.host_of_rank

    def __eq__(self, other):
        return (isinstance(other, Topology)
                and self.host_of_rank == other.host_of_rank)

    def __hash__(self):
        return hash(self.host_of_rank)

    def __repr__(self):
        return (f"Topology(num_hosts={self.num_hosts}, "
                f"ranks_per_host={self.ranks_per_host})")


def span_hosts(host_of_rank: Sequence[int], members: Sequence[int]) -> int:
    """How many hosts ``members`` (world ranks) span under
    ``host_of_rank``."""
    return len({host_of_rank[m] for m in members}) if members else 0


def link_class(host_of_rank: Optional[Sequence[int]], a: int, b: int) -> str:
    """``"dcn"`` when ranks ``a`` and ``b`` live on different hosts,
    ``"ici"`` otherwise (and when no topology is known)."""
    if host_of_rank is None:
        return "ici"
    return "ici" if host_of_rank[a] == host_of_rank[b] else "dcn"


def from_counts(counts: Sequence[int]) -> Topology:
    """Topology from per-host rank counts: ``(3, 5)`` -> ranks 0-2 on host
    0, ranks 3-7 on host 1."""
    host_of_rank = []
    for h, c in enumerate(counts):
        host_of_rank.extend([h] * c)
    return Topology(host_of_rank)


def derive_world_topology(comm) -> Optional[Topology]:
    """The host partition of ``comm``'s flat rank space, or ``None``: the
    ``MPI4JAX_TPU_TOPOLOGY`` spec when its rank count matches the comm's
    world.  The port has no other source of host labels (its ranks are
    processes of one host), so without the spec there is no partition."""
    spec = config.topology_spec()
    if not spec:
        return None
    try:
        world = comm.world_size()
    except RuntimeError:  # unbound comm
        return None
    counts = config.parse_topology_spec(spec)
    return from_counts(counts) if counts and sum(counts) == world else None
