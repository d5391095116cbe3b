"""The host-topology model: where ranks live.

PyTorch counterpart of ``mpi4jax_tpu/parallel/topology.py``: the
:class:`Topology` of a flat rank space (each rank's canonical host), the
host span of a group and the link class of a rank pair, which the
hierarchical lowerings (``ops/_hierarchy.py``) and the cost pass
(``analysis/cost.py``) read.  A topology comes from

- the ``MPI4JAX_TPU_TOPOLOGY`` override (``<hosts>x<ranks_per_host>`` or
  per-host counts ``3,5``) when its rank count matches the comm's world
  (the spec wins); or
- the grid's host layout (``mesh_topology``): where the JAX package reads
  each device's ``process_index``, the port reads each rank's host label
  (``host_label``, the host name), exchanged once per world through the
  rendezvous store (every rank writes its own at ``init_distributed``,
  ``host_labels`` reads them: no collective).  On one machine every rank has one label:
  one host, so the flat algorithms run.

Host ids are canonical (renumbered by first appearance), so only the
partition matters.  Where no partition can be established (an unbound
comm, a spec of another rank count, a grid whose slabs disagree)
``derive_world_topology`` returns ``None`` and every link is ``ici``, the
flat-fallback convention: topology never turns a working program into an
error.
"""

from __future__ import annotations

import socket
from collections import OrderedDict
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


def host_label() -> str:
    """This process's host label (the host name)."""
    return socket.gethostname()


_STORE_KEY = "mpi4jax_tpu_torch/host/"


def publish_host_label() -> None:
    """Write this rank's ``host_label()`` into the world's rendezvous
    store (``init_distributed`` does, right after the rendezvous), and
    forget the labels read so far.  A test that fakes a label calls it
    again on every rank and meets a barrier before the first query."""
    import torch.distributed as dist

    from .mesh import _World

    _World.hosts = None
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        store = dist.distributed_c10d._get_default_store()
        store.set(_STORE_KEY + str(dist.get_rank()), host_label())


def host_labels() -> Tuple[str, ...]:
    """Every world rank's host label, in global-rank order (this process's
    alone outside an initialised world of several ranks): read once per
    world from the rendezvous store, where every rank wrote its own at
    ``init_distributed`` (no collective: a rank that died since still
    answers), and kept until the world is torn down."""
    import torch.distributed as dist

    from .mesh import _World

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return (host_label(),)
    if _World.hosts is None:
        store = dist.distributed_c10d._get_default_store()
        _World.hosts = tuple(store.get(_STORE_KEY + str(r)).decode()
                             for r in range(dist.get_world_size()))
    return _World.hosts


def mesh_topology(mesh, axes: Tuple[str, ...]) -> Optional[Topology]:
    """Host partition of the flat rank space over ``axes`` of the grid
    ``mesh``, from each rank's host label (``host_labels``).  The flat
    order is row-major over ``axes``; on a comm over some of the grid's
    axes every position on the other axes is one copy of the comm, and a
    topology exists only when every copy shows the same canonical
    pattern (else ``None``).  A grid without an initialised world (a
    virtual grid of the verifier) lives on this process's host."""
    import itertools

    if any(a not in mesh.axes for a in axes):
        return None
    labels = host_labels()
    if len(labels) == 1:
        labels = labels * mesh.size
    if len(labels) != mesh.size:
        return None
    idx = [mesh.axes.index(a) for a in axes]
    rest = [range(1) if a in axes else range(n)
            for a, n in zip(mesh.axes, mesh.shape)]
    k = 1
    for a in axes:
        k *= mesh.axis_size(a)
    patterns = set()
    for base in itertools.product(*rest):
        row = []
        for r in range(k):
            coord = list(base)
            for i in reversed(idx):
                coord[i] = r % mesh.shape[i]
                r //= mesh.shape[i]
            row.append(labels[mesh.rank_at(coord)])
        patterns.add(canonical_labels(row))
    if len(patterns) != 1:
        return None
    return Topology(patterns.pop())


# memoized per spec or (grid, axes, labels): derivation runs at every
# collective that consults the hierarchy
_topo_memo: "OrderedDict" = OrderedDict()
_TOPO_MEMO_MAX = 64
_NO_TOPO = object()


def derive_world_topology(comm) -> Optional[Topology]:
    """The host partition of ``comm``'s flat rank space, or ``None`` (the
    caller keeps the flat algorithms).  Priority: the
    ``MPI4JAX_TPU_TOPOLOGY`` spec when its rank count matches the comm's
    world (a spec of another count gives ``None`` for that comm);
    otherwise the grid's host layout (``mesh_topology``)."""
    spec = config.topology_spec()
    if spec:
        try:
            world = comm.world_size()
        except RuntimeError:  # unbound comm
            return None
        key = ("spec", spec, world)
    else:
        mesh = comm.mesh
        if mesh is None:
            return None
        key = ("mesh", mesh, comm.axes, host_labels())
    cached = _topo_memo.get(key)
    if cached is not None:
        _topo_memo.move_to_end(key)
        return None if cached is _NO_TOPO else cached
    if spec:
        counts = config.parse_topology_spec(spec)
        topo = from_counts(counts) if counts and sum(counts) == world else None
    else:
        topo = mesh_topology(mesh, comm.axes)
    _topo_memo[key] = _NO_TOPO if topo is None else topo
    if len(_topo_memo) > _TOPO_MEMO_MAX:
        _topo_memo.popitem(last=False)
    return topo
