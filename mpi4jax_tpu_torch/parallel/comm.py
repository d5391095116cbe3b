"""Communicators over named process-grid axes.

PyTorch counterpart of ``mpi4jax_tpu/parallel/comm.py:48-289``: a ``Comm``
is a set of axes of a process grid (``parallel/mesh.py``).  ``sub`` selects
the row or column communicator of a Cartesian grid, as ``MPI_Comm_split``
does there.  On a grid of several processes a comm's ranks are the
processes that share this process's coordinates on every other axis;
``members`` lists their global ranks in comm-rank order and ``group`` is
their ``torch.distributed`` process group, made on every rank when the
grid was built.  Point-to-point ops translate a comm rank to a global
rank (``global_rank``) and use the default group.  ``Split``, ``Clone``
and color groups are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .mesh import ProcessGrid, group_of


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
    def device(self):
        return self._bound().device

    def _bound(self) -> ProcessGrid:
        if self._mesh is None:
            raise RuntimeError(
                f"Comm({self._axes}) is not bound to a process grid; pass "
                "mesh= (make_world_mesh)"
            )
        return self._mesh

    def Get_size(self) -> int:
        """Number of ranks along this comm's axes."""
        mesh = self._bound()
        size = 1
        for a in self._axes:
            size *= mesh.axis_size(a)
        return size

    def Get_rank(self) -> int:
        """This process's linear rank along the comm's axes (row-major)."""
        mesh = self._bound()
        rank = 0
        for a in self._axes:
            rank = rank * mesh.axis_size(a) + mesh.axis_index(a)
        return rank

    rank = Get_rank
    size = Get_size

    def members(self) -> Tuple[int, ...]:
        """The global rank of every rank of this comm, in comm-rank order
        (row-major over the comm's axes; this process's coordinates on the
        grid's other axes)."""
        if self._members is not None:
            return self._members
        mesh = self._bound()
        base = list(mesh.coords())
        idx = [mesh.axes.index(a) for a in self._axes]
        out = []
        for r in range(self.Get_size()):
            coord = list(base)
            for i in reversed(idx):
                coord[i] = r % mesh.shape[i]
                r //= mesh.shape[i]
            out.append(mesh.rank_at(coord))
        self._members = tuple(out)
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
        return self._bound().axis_index(axis)

    def sub(self, *axes: str) -> "Comm":
        """Communicator over a subset of this comm's axes: on a grid
        ``("py", "px")``, ``comm.sub("px")`` is the row communicator."""
        for a in axes:
            if a not in self._axes:
                raise ValueError(f"axis {a!r} not in comm axes {self._axes}")
        return Comm(axes, mesh=self._mesh)

    def __repr__(self):
        return f"Comm({self._axes})"
