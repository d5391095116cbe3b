"""Communicators over named process-grid axes, and their color splits.

PyTorch counterpart of ``mpi4jax_tpu/parallel/comm.py``: a ``Comm`` is a
set of axes of a process grid (``parallel/mesh.py``).  ``sub`` selects
the row or column communicator of a Cartesian grid, as ``MPI_Comm_split``
does there.  On a grid of several processes a comm's ranks are the
processes that share this process's coordinates on every other axis;
``members`` lists their global ranks in comm-rank order and ``group`` is
their ``torch.distributed`` process group, made on every rank when the
grid (or the split) was built.  Point-to-point ops translate a comm rank
to a global rank (``global_rank``) and use the default group.

Every comm has an ``epoch``, the communication epoch it was built in
(``resilience/elastic.py``): ``Clone``, ``Split``, ``sub`` and ``bind``
inherit it, ``shrink`` (the comm half of an elastic shrink) stamps the
current one, and a collective on a comm of a revoked epoch raises MPX126
(``ops/_base.py:check_comm``); one on a comm whose world drained past its
leave boundary (``drained``) raises MPX127.

While the collective verifier re-runs a program abstractly for one rank
(``analysis/schedule.py:scope``), a comm answers for that rank:
``Get_rank`` returns it as a ``RankConcrete`` (an int for data, refused
as a root, tag or routing, MPX104), and ``axis_index`` and ``members``
give its coordinates and peers.  Outside such a run each costs one list
index more.

Every comm has a ``uid``, its point-to-point matching namespace: ``send``
and ``recv`` match per (uid, tag), and ``Clone``/``Dup`` give a fresh one
over the same ranks.  uids count the comms this process built, so every
rank must build its comms in the same order (one program on every rank,
as the grid itself needs).

``Split("axis")`` is the grid form (the comm over the remaining axes).
``Split(colors, key=None)`` takes every rank's color (the SPMD form of
MPI's per-process argument) and returns a ``GroupComm``: ranks of one
color form a group, ordered by ``(key[r], r)``; integer colors order the
groups numerically.  Every rank creates the process group of every group
of more than one rank, in one sorted order, before it returns; a group of
one rank needs none.
"""

from __future__ import annotations

import itertools
import numbers
from math import prod
from typing import Optional, Tuple

import torch.distributed as dist

from ..analysis import schedule as _schedule
from ..resilience import elastic as _elastic
from .mesh import ProcessGrid, ensure_groups, group_of

_uid_counter = itertools.count()


def next_uid() -> int:
    """The uid the next comm this process builds will take."""
    global _uid_counter
    n = next(_uid_counter)
    _uid_counter = itertools.count(n)
    return n


def resume_uids_at(uid: int) -> None:
    """Number this process's next comms from ``uid`` on: a process that
    joins a running world (``elastic.join_and_run``) takes the uid the
    world's ranks give the grown world's comm, so that point-to-point
    messages match in one namespace on every rank."""
    global _uid_counter
    _uid_counter = itertools.count(int(uid))


def _color_order_key(colors):
    """Group order of Split's colors: numeric when every color is a number
    (so 10 sorts after 2, as MPI's integer colors do), else by string."""
    if all(isinstance(c, numbers.Real) and not isinstance(c, bool)
           for c in colors):
        return lambda kv: float(kv[0])
    return lambda kv: str(kv[0])


class Comm:
    """A communicator over one or more axes of a process grid.

    ``axes`` is an axis name or a sequence of them; several axes form one
    flat group in row-major order.  ``mesh`` binds the comm to a grid,
    which ``Get_size`` and ``Get_rank`` need.
    """

    def __init__(self, axes, *, mesh: Optional[ProcessGrid] = None):
        if isinstance(axes, str):
            axes = (axes,)
        self._axes: Tuple[str, ...] = tuple(axes)
        if not self._axes:
            raise ValueError("Comm needs at least one mesh axis name")
        self._mesh = mesh
        self._members = None
        self._uid = next(_uid_counter)
        self._epoch = _elastic.current_epoch()
        if mesh is not None:
            missing = [a for a in self._axes if a not in mesh.axes]
            if missing:
                raise ValueError(
                    f"axes {missing} not present in mesh axes {mesh.axes}"
                )

    @property
    def axes(self) -> Tuple[str, ...]:
        return self._axes

    @property
    def mesh(self) -> Optional[ProcessGrid]:
        return self._mesh

    @property
    def uid(self) -> int:
        """This comm's point-to-point matching namespace."""
        return self._uid

    @property
    def epoch(self) -> int:
        """The communication epoch this comm was built in (0 for the whole
        life of a job that never shrank)."""
        return self._epoch

    @property
    def drained(self) -> bool:
        """True once this comm's world executed a planned drain past its
        leave boundary (``resilience/elastic.py``): its ranks include ranks
        that left on purpose, so a collective on it raises MPX127.  A comm
        merely scheduled to drain stays False through the boundary."""
        return _elastic.comm_drained(self._uid)

    @property
    def device(self):
        return self._bound().device

    @property
    def groups(self):
        """The groups of a color split (``None`` here; see ``GroupComm``)."""
        return None

    def _bound(self) -> ProcessGrid:
        if self._mesh is None:
            raise RuntimeError(
                f"Comm({self._axes}) is not bound to a process grid; pass "
                "mesh= (make_world_mesh)"
            )
        return self._mesh

    def bind(self, mesh: ProcessGrid) -> "Comm":
        """This comm bound to ``mesh``, in the same matching namespace."""
        new = Comm(self._axes, mesh=mesh)
        new._uid = self._uid
        new._epoch = self._epoch
        return new

    def Get_size(self) -> int:
        """Number of ranks along this comm's axes."""
        mesh = self._bound()
        size = 1
        for a in self._axes:
            size *= mesh.axis_size(a)
        return size

    def Get_rank(self) -> int:
        """This process's linear rank along the comm's axes (row-major);
        during a per-rank abstract run, the analyzed rank's
        (``RankConcrete``)."""
        mesh = self._bound()
        if _schedule.ACTIVE[0]:
            concrete = _schedule.concrete_comm_rank(self._axes)
            if concrete is not None:
                return concrete
        rank = 0
        for a in self._axes:
            rank = rank * mesh.axis_size(a) + mesh.axis_index(a)
        return rank

    def _coords(self) -> Tuple[int, ...]:
        """This process's grid coordinates, or the analyzed rank's during
        a per-rank abstract run over the grid's axes."""
        mesh = self._bound()
        if _schedule.ACTIVE[0]:
            coords = _schedule.scope_coords(mesh.axes)
            if coords is not None:
                return coords
        return mesh.coords()

    rank = Get_rank
    size = Get_size

    def world_size(self) -> int:
        """Number of ranks along this comm's axes, every group of a color
        split together (the rank space of an elastic shrink)."""
        return Comm.Get_size(self)

    def min_size(self) -> int:
        """The smallest group's size: the bound a root must satisfy."""
        return self.Get_size()

    def _members_at(self, base) -> Tuple[int, ...]:
        """The global rank of every flat rank along the comm's axes, at grid
        coordinates ``base`` on the other axes."""
        mesh = self._bound()
        idx = [mesh.axes.index(a) for a in self._axes]
        out = []
        for r in range(Comm.Get_size(self)):
            coord = list(base)
            for i in reversed(idx):
                coord[i] = r % mesh.shape[i]
                r //= mesh.shape[i]
            out.append(mesh.rank_at(coord))
        return tuple(out)

    def _all_member_tables(self):
        """``_members_at`` for every position on the grid's other axes: the
        process sets of every copy of this comm."""
        mesh = self._bound()
        rest = [range(1) if a in self._axes else range(n)
                for a, n in zip(mesh.axes, mesh.shape)]
        return [self._members_at(base) for base in itertools.product(*rest)]

    def members(self) -> Tuple[int, ...]:
        """The global rank of every rank of this comm, in comm-rank order
        (row-major over the comm's axes; this process's coordinates on the
        grid's other axes)."""
        if _schedule.ACTIVE[0]:
            return self._members_at(self._coords())
        if self._members is None:
            self._members = self._members_at(self._bound().coords())
        return self._members

    def global_rank(self, rank: int) -> int:
        """The global rank of this comm's rank ``rank``."""
        return self.members()[rank]

    def group(self):
        """The ``torch.distributed`` process group of this comm's ranks
        (``None``: the default group, the whole world)."""
        return group_of(frozenset(self.members()))

    def axis_index(self, axis: str) -> int:
        """This process's coordinate along one grid axis (the counterpart of
        ``jax.lax.axis_index`` inside the JAX package's regions)."""
        mesh = self._bound()
        if _schedule.ACTIVE[0]:
            return self._coords()[mesh.axes.index(axis)]
        return mesh.axis_index(axis)

    def sub(self, *axes: str) -> "Comm":
        """Communicator over a subset of this comm's axes: on a grid
        ``("py", "px")``, ``comm.sub("px")`` is the row communicator."""
        for a in axes:
            if a not in self._axes:
                raise ValueError(f"axis {a!r} not in comm axes {self._axes}")
        return self._derived(Comm(axes, mesh=self._mesh))

    def _derived(self, new: "Comm") -> "Comm":
        new._epoch = self._epoch
        return new

    def Clone(self) -> "Comm":
        """A fresh matching namespace over the same ranks: a send on the
        clone never matches a recv on this comm."""
        return self._derived(Comm(self._axes, mesh=self._mesh))

    Dup = Clone

    def Split(self, color, key=None) -> "Comm":
        """``MPI_Comm_split``.  ``Split("axis")``: the comm over the other
        axes (the grid form).  ``Split(colors, key=None)``: ``colors`` and
        ``key`` list every rank's value, in comm-rank order; returns a
        ``GroupComm`` of the groups ordered by color, each ordered by
        ``(key[r], r)``."""
        if isinstance(color, str):
            remaining = tuple(a for a in self._axes if a != color)
            if not remaining:
                raise ValueError("Split would leave an empty communicator")
            return self._derived(Comm(remaining, mesh=self._mesh))
        size = self.Get_size()
        colors = list(color)
        if len(colors) != size:
            raise ValueError(
                f"Split: colors must list every rank's color (got "
                f"{len(colors)} entries for {size} ranks): every rank runs "
                "the same program, so the whole color table is required"
            )
        keys = list(key) if key is not None else [0] * size
        if len(keys) != size:
            raise ValueError(
                f"Split: key must have one entry per rank "
                f"(got {len(keys)} for {size})"
            )
        by_color = {}
        for r in range(size):
            by_color.setdefault(colors[r], []).append(r)
        groups = tuple(
            tuple(sorted(members, key=lambda r: (keys[r], r)))
            for _, members in sorted(by_color.items(),
                                     key=_color_order_key(colors))
        )
        return GroupComm(self, groups)

    def shrink(self, failed, *, mesh: ProcessGrid) -> "Comm":
        """This comm rebuilt as "all minus ``failed``" over the post-shrink
        grid ``mesh`` (``shrink_world_mesh``, or the grid of the world a
        re-bootstrap initialised): the comm half of an elastic shrink (the
        analog of ULFM's ``MPI_Comm_shrink``).  ``failed`` are old-world
        global ranks; survivors are renumbered compactly in ascending
        old-rank order (``compact_rank_map``).  The result is a NEW comm
        (fresh matching namespace) stamped with the current epoch."""
        failed = frozenset(int(r) for r in failed)
        world = self.world_size()
        rmap = _elastic.compact_rank_map(world, failed)
        expect = len(rmap)
        got = prod(mesh.axis_size(a) for a in self._axes if a in mesh.axes)
        if got != expect:
            raise ValueError(
                f"shrink: grid spans {got} ranks along axes {self._axes} "
                f"but {expect} of {world} ranks survive — pass the grid "
                "shrink_world_mesh built for this failure"
            )
        return Comm(self._axes, mesh=mesh)

    def __repr__(self):
        return f"Comm({self._axes}, uid={self._uid}, epoch={self._epoch})"


class GroupComm(Comm):
    """A color split: a partition of a comm's ranks into groups.

    ``groups`` holds tuples of flat ranks along the comm's axes (the parent
    comm's ranks), each in group order.  ``Get_rank`` is the rank within
    this process's group and ``Get_size`` the group size, which exists only
    when every group has the same size: the gather family (``allgather``,
    ``alltoall``, ``gather``, ``scatter``, ``reduce_scatter``) needs it and
    so refuses unequal groups, as the JAX package does; the other ops run
    on any partition.  ``members`` and ``group`` are this process's group.
    """

    def __init__(self, parent: Comm, groups, *, derived=None):
        super().__init__(parent.axes, mesh=parent.mesh)
        if derived is not None:
            # a comm the algorithm layer derives (ops/_hierarchy.py): it
            # takes no uid from this process's count, so that building it
            # on one rank and not on another never shifts the uids of the
            # comms built after it; its process groups are made by
            # ``make_groups``, where it is first used
            global _uid_counter
            _uid_counter = itertools.count(self._uid)
            self._uid = (parent.uid, derived)
        self._epoch = parent.epoch
        world = Comm.Get_size(self)
        seen = [r for g in groups for r in g]
        if sorted(seen) != sorted(set(seen)):
            raise ValueError(f"Split groups overlap: {groups}")
        if sorted(seen) != list(range(world)):
            raise ValueError(
                f"Split groups {groups} must partition all {world} ranks "
                "(every rank needs a group)"
            )
        self._groups = tuple(tuple(int(r) for r in g) for g in groups)
        self._gid = [0] * world
        self._lrank = [0] * world
        for g, members in enumerate(self._groups):
            for i, r in enumerate(members):
                self._gid[r] = g
                self._lrank[r] = i
        if derived is None:
            self.make_groups()

    def make_groups(self) -> None:
        """Create the process group of every group of more than one rank
        that has none yet, on every copy of the comm.  Collective where it
        creates one: every rank calls it with the same groups."""
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            # collective: every rank creates every group, in one order
            ensure_groups(frozenset(table[r] for r in g)
                          for table in self._all_member_tables()
                          for g in self._groups)

    @property
    def groups(self):
        return self._groups

    def uniform_size(self) -> Optional[int]:
        """The size every group has, or ``None`` for unequal groups."""
        sizes = {len(g) for g in self._groups}
        return sizes.pop() if len(sizes) == 1 else None

    def Get_size(self) -> int:
        size = self.uniform_size()
        if size is None:
            raise RuntimeError(
                f"Get_size on a color-split comm with unequal group sizes "
                f"{sorted(len(g) for g in self._groups)} has no single value. "
                "Only the gather family (allgather/alltoall/gather/scatter) "
                "and reduce_scatter need uniform groups; every other op "
                "works on unequal groups."
            )
        return size

    def Get_rank(self) -> int:
        """This process's rank within its group (a ``RankConcrete`` during
        a per-rank abstract run)."""
        flat = Comm.Get_rank(self)
        if type(flat) is _schedule.RankConcrete:
            return _schedule.RankConcrete(self._lrank[flat])
        return self._lrank[flat]

    rank = Get_rank
    size = Get_size

    def min_size(self) -> int:
        return min(len(g) for g in self._groups)

    def members(self) -> Tuple[int, ...]:
        if _schedule.ACTIVE[0]:
            table = self._members_at(self._coords())
            mine = self._groups[self._gid[Comm.Get_rank(self)]]
            return tuple(table[r] for r in mine)
        if self._members is None:
            table = self._members_at(self._bound().coords())
            mine = self._groups[self._gid[Comm.Get_rank(self)]]
            self._members = tuple(table[r] for r in mine)
        return self._members

    def _copy(self) -> "GroupComm":
        new = GroupComm.__new__(GroupComm)
        Comm.__init__(new, self._axes, mesh=self._mesh)
        new._groups, new._gid, new._lrank = self._groups, self._gid, self._lrank
        new._epoch = self._epoch
        return new

    def shrink(self, failed, *, mesh: ProcessGrid) -> "GroupComm":
        """Shrink a color split: drop the failed ranks from every group,
        renumber the survivors compactly (``shrink_groups`` keeps each
        group's member order), drop groups that lost every member, and
        rebuild over the post-shrink grid ``mesh``: a fresh current-epoch
        ``GroupComm``, the split's partition kept.  Creating its groups'
        process groups is collective, as ``Split`` is."""
        failed = frozenset(int(r) for r in failed)
        world = self.world_size()
        new_groups = _elastic.shrink_groups(self._groups, failed, world)
        parent = Comm(self._axes, mesh=mesh)
        expect = world - len(failed)
        got = parent.world_size()
        if got != expect:
            raise ValueError(
                f"shrink: grid spans {got} ranks along axes {self._axes} "
                f"but {expect} of {world} ranks survive — pass the grid "
                "shrink_world_mesh built for this failure"
            )
        return GroupComm(parent, new_groups)

    def Clone(self) -> "GroupComm":
        """The same groups in a fresh matching namespace (their process
        groups exist already)."""
        return self._copy()

    Dup = Clone

    def bind(self, mesh: ProcessGrid) -> "GroupComm":
        """Bound to ``mesh``, keeping the groups and the namespace."""
        new = self._copy()
        new._mesh = mesh
        new._uid = self._uid
        return new

    def sub(self, *axes: str) -> "Comm":
        raise ValueError(
            "sub() on a color-split comm is not supported — take sub-comms "
            "from the parent comm before splitting"
        )

    def Split(self, color, key=None) -> "GroupComm":
        """Nested split: ``colors`` and ``key`` list a value for every flat
        rank of the parent comm (GLOBAL rank order, as the first split's
        tables), and groups form within each existing group, ordered by
        ``(key, old group rank)``."""
        if isinstance(color, str):
            raise ValueError(
                "grid splits of a color-split comm are not supported — take "
                "sub-comms from the parent comm before splitting"
            )
        n = len(self._lrank)
        colors = list(color)
        if len(colors) != n:
            raise ValueError(
                f"Split: colors must list every rank's color (got "
                f"{len(colors)} entries for {n} ranks; on a color-split comm "
                "the table is indexed by GLOBAL rank)"
            )
        keys = list(key) if key is not None else [0] * n
        if len(keys) != n:
            raise ValueError(
                f"Split: key must have one entry per rank (got {len(keys)} for {n})"
            )
        new_groups = []
        order = _color_order_key(colors)
        for members in self._groups:
            by_color = {}
            for i, r in enumerate(members):
                by_color.setdefault(colors[r], []).append((keys[r], i, r))
            for _, lst in sorted(by_color.items(), key=order):
                new_groups.append(tuple(r for _, _, r in sorted(lst)))
        return GroupComm(self, tuple(new_groups))

    def __repr__(self):
        return (f"GroupComm({self._axes}, groups={self._groups}, "
                f"uid={self._uid}, epoch={self._epoch})")
