"""Process grids: the port's counterpart of a device mesh.

``mpi4jax_tpu/parallel/mesh.py:make_world_mesh`` builds a JAX mesh over
devices, one SPMD program for every rank.  The port runs one process per
rank, so its "mesh" is a descriptor: the grid's shape, its axis names,
this process's rank in it and the ``torch.device`` it computes on.

A grid of one rank needs no ``torch.distributed``.  A grid of more ranks
needs an initialised world of exactly that size (``init_distributed``, or
``parallel/launch.py:run``, which starts the ranks and initialises it), and
building it creates the process group of every row, column and other
sub-grid, on every rank and in the same order (``dist.new_group`` is
collective), so that ``Comm.sub`` never creates a group lazily; a color
split (``Comm.Split``) creates its groups the same way (``ensure_groups``).

Devices: with ``backend="gloo"`` every rank may compute on the one card
(``cuda:0``; exchanges are staged through host memory) or on the CPU
when asked; ``backend="nccl"`` needs a GPU of its own for every rank
(``cuda:local_rank``).
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from datetime import timedelta
from math import prod
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_AXIS = "mpi4jax"

HOW_TO_START_RANKS = (
    "start one process per rank with mpi4jax_tpu_torch.parallel.launch.run"
    "(fn, nprocs, backend='gloo'), or call mpi4jax_tpu_torch.parallel.mesh."
    "init_distributed in each process"
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


def device_for_rank(backend: str, device, local_rank: int,
                    local_world: int) -> torch.device:
    """The device rank ``local_rank`` of ``local_world`` ranks on this host
    computes on.  gloo: ``device`` for every rank (``None``: the GPU), so
    ranks may share one card.  nccl: ``cuda:local_rank``, one GPU per rank;
    a device shared by two ranks, or too few GPUs, raise ``ValueError``."""
    if backend == "gloo":
        return resolve_device(device)
    if backend != "nccl":
        raise ValueError(f"unknown backend {backend!r}; use 'gloo' or 'nccl'")
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"backend='nccl' needs CUDA devices, got {device}")
        if device.index is not None and local_world > 1:
            raise ValueError(
                f"backend='nccl' would put {local_world} ranks on {device}; "
                "NCCL needs one GPU per rank (use backend='gloo' to share a card)"
            )
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < local_world:
        raise ValueError(
            f"backend='nccl' needs one GPU per rank: {local_world} ranks on "
            f"this host, {have} GPU(s); two ranks would share a device (use "
            "backend='gloo' to share a card)"
        )
    return torch.device("cuda", local_rank)


class _World:
    """This process's view of the initialised world: its device, and the
    process groups made for grids so far (by member set)."""

    device: Optional[torch.device] = None
    groups: Dict[FrozenSet[int], object] = {}
    # every rank's host label (parallel/topology.py:host_labels)
    hosts: Optional[Tuple[str, ...]] = None


def init_distributed(backend: str = "gloo", *, init_method: str = None,
                     world_size: int = None, rank: int = None, device=None,
                     timeout: float = 300.0,
                     connect_timeout: Optional[float] = None,
                     connect_deadline: Optional[float] = None,
                     connect_max_attempts: Optional[int] = None,
                     connect_base_delay: float = 1.0,
                     connect_max_delay: float = 30.0) -> torch.device:
    """Initialise ``torch.distributed`` for this process (the role of
    ``mpi4jax_tpu/parallel/mesh.py:init_distributed``) and return the
    device this rank computes on.  Nothing on the host tells a process of
    its world: ``init_method`` (``tcp://localhost:<port>`` or
    ``file://<path>``), ``world_size`` and ``rank`` default to the
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``
    environment variables.  ``timeout`` (seconds) bounds every collective,
    so a lost rank errors instead of hanging.  ``connect_timeout`` bounds
    one rendezvous attempt, the wait for every rank and the connections
    between them (default: the larger of ``timeout`` and
    ``connect_deadline``); the world's collectives get ``timeout`` once it
    is made.  Ranks started together on a loaded host reach the
    rendezvous seconds apart, and an attempt cut by a collective's short
    timeout leaves its addresses in the store, where a retry's peers read
    them and cannot connect.

    The rendezvous is retried with full-jitter backoff
    (``resilience/retry.py``), as the JAX package retries its coordinator:
    a refused or failed attempt (a store's port still taken, say) is tried
    again until ``connect_deadline`` seconds have passed or
    ``connect_max_attempts`` attempts failed (defaults
    ``MPI4JAX_TPU_BOOTSTRAP_DEADLINE``, 300, and
    ``MPI4JAX_TPU_BOOTSTRAP_MAX_ATTEMPTS``, 0 for the deadline alone);
    then a ``RuntimeError`` names the attempts, the time and the last
    error.  A second initialisation of a world is not retried."""
    from ..resilience.retry import retry_with_backoff
    from ..utils import config

    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if init_method is None:
        init_method = "env://"
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = device_for_rank(backend, device, local_rank, local_world)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if connect_deadline is None:
        connect_deadline = config.bootstrap_deadline()
    if connect_max_attempts is None:
        connect_max_attempts = config.bootstrap_max_attempts()
    if connect_timeout is None:
        connect_timeout = max(timeout, connect_deadline)

    def connect():
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timedelta(seconds=connect_timeout))

    retry_with_backoff(
        connect,
        what=f"torch.distributed rendezvous ({init_method}, rank {rank} of "
             f"{world_size})",
        deadline=connect_deadline,
        max_attempts=connect_max_attempts or None,
        base_delay=connect_base_delay,
        max_delay=connect_max_delay,
        # a second initialisation is a programming error, not a refusal
        giveup=lambda e: "twice" in str(e) or dist.is_initialized(),
    )
    if connect_timeout != timeout:
        dist.distributed_c10d._set_pg_timeout(timedelta(seconds=timeout))
    _World.device = dev
    _World.groups = {}
    from .topology import publish_host_label

    publish_host_label()
    return dev


def world_device() -> Optional[torch.device]:
    """The device ``init_distributed`` chose for this rank, if it ran."""
    return _World.device if dist.is_available() and dist.is_initialized() else None


def group_of(members: FrozenSet[int]):
    """The process group over ``members`` (global ranks), made when the grid
    was built; ``None`` is the default group (the whole world)."""
    if len(members) == dist.get_world_size():
        return None
    try:
        return _World.groups[members]
    except KeyError:
        raise RuntimeError(
            f"no process group over ranks {sorted(members)}: groups are made "
            "on every rank when make_world_mesh builds the grid or "
            "Comm.Split splits a comm"
        ) from None


def _grid_ranks(shape, keep: Tuple[int, ...]):
    """The member sets of the sub-grids along axes ``keep`` (one per
    position on the other axes), each a frozenset of global ranks."""
    rest = [i for i in range(len(shape)) if i not in keep]
    out = []
    for fixed in itertools.product(*(range(shape[i]) for i in rest)):
        members = []
        for free in itertools.product(*(range(shape[i]) for i in keep)):
            coord = [0] * len(shape)
            for i, c in zip(rest, fixed):
                coord[i] = c
            for i, c in zip(keep, free):
                coord[i] = c
            r = 0
            for n, c in zip(shape, coord):
                r = r * n + c
            members.append(r)
        out.append(frozenset(members))
    return out


def ensure_groups(member_sets) -> None:
    """Create the process group of every set of global ranks in
    ``member_sets`` with more than one rank and fewer than all that has
    none yet, in ascending order of the sorted sets.  Collective: every
    rank calls it with the same sets (``dist.new_group`` is collective)."""
    world = dist.get_world_size()
    todo = {frozenset(s) for s in member_sets}
    for members in sorted(todo, key=sorted):
        if 1 < len(members) < world and members not in _World.groups:
            _World.groups[members] = dist.new_group(sorted(members))


def _make_groups(shape: Tuple[int, ...]) -> None:
    """Create the process group of every sub-grid of ``shape`` with more
    than one rank and fewer than all (``ensure_groups``)."""
    ensure_groups(members for k in range(1, len(shape))
                  for keep in itertools.combinations(range(len(shape)), k)
                  for members in _grid_ranks(shape, keep))


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

    def coords(self, rank: int = None) -> Tuple[int, ...]:
        """The coordinate along every axis of ``rank`` (default: this
        process)."""
        out, r = [], self.rank if rank is None else rank
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def axis_index(self, axis: str) -> int:
        return self.coords()[self.axes.index(axis)]

    def rank_at(self, coords: Sequence[int]) -> int:
        """The global rank at grid coordinates ``coords``."""
        r = 0
        for n, c in zip(self.shape, coords):
            r = r * n + c
        return r


def make_world_mesh(
    shape: Optional[Sequence[int]] = None,
    axes: Optional[Sequence[str]] = None,
    *,
    device=None,
) -> ProcessGrid:
    """The world's process grid.  Default: a 1-D grid named ``"mpi4jax"``
    over every process.  Pass ``shape``/``axes`` for Cartesian grids, e.g.
    ``make_world_mesh((2, 4), ("py", "px"))``.  A grid of more than one
    rank needs an initialised world of its size; ``device=None`` is then
    the device ``init_distributed`` chose for this rank."""
    initialised = dist.is_available() and dist.is_initialized()
    if shape is None:
        shape = (dist.get_world_size() if initialised else 1,)
    shape = tuple(int(n) for n in shape)
    if axes is None:
        axes = ((DEFAULT_AXIS,) if len(shape) == 1
                else tuple(f"ax{i}" for i in range(len(shape))))
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    size = prod(shape)
    if size == 1 and not (initialised and dist.get_world_size() > 1):
        return ProcessGrid(shape, axes, resolve_device(device))
    if not initialised:
        raise RuntimeError(
            f"mesh shape {shape} spans {size} ranks, but torch.distributed "
            f"is not initialised in this process; {HOW_TO_START_RANKS}"
        )
    world = dist.get_world_size()
    if size != world:
        raise ValueError(
            f"mesh shape {shape} spans {size} ranks, but the world has {world}"
        )
    if device is None:
        device = world_device()
    _make_groups(shape)
    return ProcessGrid(shape, axes, resolve_device(device), dist.get_rank())


def shrink_world_mesh(mesh: ProcessGrid, failed,
                      fail_unit: str = "rank") -> ProcessGrid:
    """The grid ``mesh`` without the ``failed`` global ranks (row-major,
    the rank space ``Comm.Get_rank`` defines): the grid half of an elastic
    shrink (``resilience/elastic.py``).

    ``fail_unit`` is the shrink's granularity
    (``MPI4JAX_TPU_ELASTIC_FAIL_UNIT``): ``"rank"`` removes exactly the
    failed ranks and needs a 1-D grid (removing ranks from a Cartesian
    grid leaves a ragged one); ``"row"``/``"col"`` remove every whole row
    (first axis) or column (second axis) holding a failed rank, so a 2-D
    grid keeps its shape minus those lines; on a 1-D grid both are
    ``"rank"``.  The port runs one process per rank, so the new grid is
    built in the world of the survivors: a re-bootstrap
    (``ShardStore.rebootstrap``) must have initialised it, at the new
    grid's size, before this is called on a world of several ranks."""
    from ..resilience.elastic import expand_fail_unit, shrunken_shape

    shape = tuple(mesh.shape)
    failed = expand_fail_unit(failed, shape, fail_unit)
    if len(shape) > 1 and fail_unit == "rank":
        raise ValueError(
            f"shrink_world_mesh: only 1-D grids can shrink by rank (got "
            f"shape {dict(zip(mesh.axes, shape))}); arbitrary rank removal "
            "leaves a ragged grid — shrink whole grid rows/columns instead "
            "(fail_unit='row'|'col', MPI4JAX_TPU_ELASTIC_FAIL_UNIT)"
        )
    if len(failed) >= mesh.size:
        raise ValueError("shrink_world_mesh: no surviving ranks")
    new_shape = shrunken_shape(shape, failed, fail_unit)
    return make_world_mesh(new_shape, mesh.axes, device=mesh.device)


def grow_world_mesh(mesh: ProcessGrid, added: int) -> ProcessGrid:
    """The grid ``mesh`` with ``added`` ranks appended: the grid half of an
    elastic grow (``resilience/elastic.py``).  1-D grids only (joiners
    append to the end of the rank line).  The port runs one process per
    rank, so the new grid is built in the grown world: a re-bootstrap
    (``ShardStore.rebootstrap_grow``) must have initialised it, at the new
    grid's size, first."""
    shape = tuple(mesh.shape)
    if len(shape) != 1:
        raise ValueError(
            f"grow_world_mesh: only 1-D grids can grow (got shape "
            f"{dict(zip(mesh.axes, shape))})")
    if added < 1:
        raise ValueError(f"grow_world_mesh: added must be >= 1, got {added}")
    return make_world_mesh((shape[0] + int(added),), mesh.axes,
                           device=mesh.device)


# the default grid and the world it was built in (or set for)
_default_mesh: tuple = (None, None)


def _world_key():
    return ((dist.get_world_size(), dist.get_rank())
            if dist.is_available() and dist.is_initialized() else None)


def get_default_mesh() -> ProcessGrid:
    """The world's default grid: ``make_world_mesh()`` (a 1-D grid named
    ``"mpi4jax"`` over every process), built once per world, or the grid
    ``set_default_mesh`` gave for it.  ``get_default_comm`` builds its comm
    on it.  Building a grid of several ranks is collective: every rank must
    ask."""
    global _default_mesh
    world = _world_key()
    if _default_mesh[1] is None or _default_mesh[0] != world:
        _default_mesh = (world, make_world_mesh())
    return _default_mesh[1]


def set_default_mesh(mesh: Optional[ProcessGrid]) -> None:
    """Replace the default grid of this world (``None``: build it anew at
    the next ``get_default_mesh``).  A default comm built already keeps its
    grid, as in the JAX package."""
    global _default_mesh
    _default_mesh = (_world_key(), mesh)


def forget_world() -> None:
    """Drop everything this layer built for the current world: the grid's
    device, its process groups (``group_of`` keys them by member set, so a
    stale group of the same members could come back after a shrink), and
    the default grid and comm.  Called when a world is revoked or torn
    down; the next grid or default comm is built afresh."""
    global _default_mesh
    from . import region

    _World.device = None
    _World.groups = {}
    _World.hosts = None
    _default_mesh = (None, None)
    region._default = (None, None)
