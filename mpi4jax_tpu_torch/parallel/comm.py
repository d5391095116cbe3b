"""Communicators over named process-grid axes.

PyTorch counterpart of ``mpi4jax_tpu/parallel/comm.py:48-289``: a ``Comm``
is a set of axes of a process grid (``parallel/mesh.py``).  ``sub`` selects
the row or column communicator of a Cartesian grid, as ``MPI_Comm_split``
does there.  This slice covers the size-1 world; ``Split``, ``Clone``,
color groups and real process groups come with the multi-rank slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .mesh import ProcessGrid


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
