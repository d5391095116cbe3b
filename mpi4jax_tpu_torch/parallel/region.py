"""Parallel regions: the scope that gives ops a default comm, and that
fusion and overlap flush at its end.

PyTorch counterpart of ``mpi4jax_tpu/parallel/region.py``.  There,
``spmd`` traces one program for every rank with ``jax.shard_map``; here
each process already is one rank and runs its ops as it calls them, so
``spmd(comm=...)`` is an eager scope around a call of the function:

- inside it, an op called with ``comm=None`` takes the region's comm
  (outside any region such a call raises, as before);
- it holds the fusion queue (``ops/_fusion.py``) and the async starts of
  the region (``ops/_async.py``);
- at its end it issues what is still queued, turns every deferred result
  among the outputs into its tensor, and waits for every start: a start
  that its function never waited raises MPX112, as the JAX package's
  verifier flags it.

Every rank must run the same regions and, in each, the same collectives
in the same order: the queue is issued at the same point of the program
on every rank.  ``spmd`` takes no ``in_specs``/``out_specs``, ``jit`` or
``unroll``: there is no trace to shard or compile.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch.distributed as dist

from .comm import Comm
from .mesh import DEFAULT_AXIS, make_world_mesh


class RegionContext:
    """The state of one region: its comm, the fusion queue (``None`` when
    empty) and the async starts issued in it."""

    def __init__(self, comm: Comm):
        self.comm = comm
        self.fusion_queue = None
        self.handles: list = []


_region_stack: List[RegionContext] = []
_default = (None, None)  # (the world it was built in, the comm)


def current_context() -> Optional[RegionContext]:
    """The innermost region's context, ``None`` outside every region."""
    return _region_stack[-1] if _region_stack else None


def get_default_comm() -> Comm:
    """Inside a region, its comm; outside, the world's comm over a 1-D
    grid named ``"mpi4jax"`` (built once per world; every rank must ask
    for it, since building a grid of several ranks is collective)."""
    ctx = current_context()
    if ctx is not None:
        return ctx.comm
    global _default
    world = ((dist.get_world_size(), dist.get_rank())
             if dist.is_available() and dist.is_initialized() else None)
    if _default[1] is None or _default[0] != world:
        _default = (world, Comm(DEFAULT_AXIS, mesh=make_world_mesh()))
    return _default[1]


def resolve_comm(comm: Optional[Comm]) -> Comm:
    return comm if comm is not None else get_default_comm()


def spmd(fn=None, *, comm: Optional[Comm] = None):
    """Run the decorated function as a region over ``comm`` (``None``: the
    enclosing region's comm, else the world's).  Usable bare
    (``@spmd``) or with arguments (``@spmd(comm=c)``)."""

    def wrap(f):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            from ..ops import _async, _fusion

            ctx = RegionContext(resolve_comm(comm))
            _region_stack.append(ctx)
            try:
                out = f(*args, **kwargs)
                _fusion.flush_pending(ctx)
                out = _fusion.materialize_tree(out)
                _async.finish_region(ctx)
                return out
            finally:
                _region_stack.pop()

        return wrapped

    return wrap(fn) if fn is not None else wrap


def run(f, *args, comm: Optional[Comm] = None, **kwargs):
    """One-shot ``spmd``: ``run(f, x)`` is ``spmd(f, comm=comm)(x)``."""
    return spmd(comm=comm)(f)(*args, **kwargs)
