"""Process grids: the port's counterpart of a device mesh.

``mpi4jax_tpu/parallel/mesh.py:make_world_mesh`` builds a JAX mesh over
devices, one SPMD program for every rank.  The port runs one process per
rank, so its "mesh" is a descriptor: the grid's shape, its axis names,
this process's rank in it and the ``torch.device`` it computes on.  This
slice runs a world of one process: ``torch.distributed`` is neither
required nor initialised, and a grid of more than one rank raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Optional, Sequence, Tuple

import torch

DEFAULT_AXIS = "mpi4jax"

# the ROADMAP item that brings real process groups (NCCL, gloo in tests)
MULTI_RANK_ITEM = (
    "ROADMAP.md Queue 1, 'Multi-rank communicator' (torch.distributed "
    "process groups)"
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  Without CUDA this raises unless the caller
    asked for the CPU: the port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


@dataclass(frozen=True)
class ProcessGrid:
    """A Cartesian grid of ranks with named axes (row-major, the first axis
    slowest), this process's ``rank`` in it, and its device."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    device: torch.device
    rank: int = 0

    @property
    def size(self) -> int:
        return prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def coords(self) -> Tuple[int, ...]:
        """This process's coordinate along every axis."""
        out, r = [], self.rank
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def axis_index(self, axis: str) -> int:
        return self.coords()[self.axes.index(axis)]


def make_world_mesh(
    shape: Optional[Sequence[int]] = None,
    axes: Optional[Sequence[str]] = None,
    *,
    device=None,
) -> ProcessGrid:
    """The world's process grid.  Default: a 1-D grid named ``"mpi4jax"``
    over every process (here: one).  Pass ``shape``/``axes`` for Cartesian
    grids, e.g. ``make_world_mesh((1, 1), ("py", "px"))``."""
    if shape is None:
        shape = (1,)
    shape = tuple(int(n) for n in shape)
    if axes is None:
        axes = ((DEFAULT_AXIS,) if len(shape) == 1
                else tuple(f"ax{i}" for i in range(len(shape))))
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if prod(shape) != 1:
        raise NotImplementedError(
            f"mesh shape {shape} spans {prod(shape)} ranks; this port runs "
            f"one process so far — see {MULTI_RANK_ITEM}"
        )
    return ProcessGrid(shape, axes, resolve_device(device))
