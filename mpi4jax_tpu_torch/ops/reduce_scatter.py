"""reduce_scatter: reduce, then scatter one block per rank.

PyTorch counterpart of ``mpi4jax_tpu/ops/reduce_scatter.py``
(``MPI_Reduce_scatter_block``): every rank passes ``(size, *s)``, block i
addressed to rank i, and rank i receives the reduction of every rank's
block i, shape ``s``.  On a color split ``size`` is the uniform group
size (unequal groups raise, as in the JAX package).  It is one
``alltoall`` of the blocks and the fold of the received rows in ascending
group-rank order (``_base.fold``), callables included; a logical
reduction of a non-bool dtype keeps that dtype, as in ``allreduce``.

Autodiff: SUM's backward is the ``allgather`` of the cotangent and its
forward mode reduce-scatters the tangent (``allgather.py:
_ReduceScatterSum``); the other reductions differentiate through the
``alltoall`` and the fold.  Inside ``overlap()`` the call is split into
``reduce_scatter_start`` and a deferred wait (``ops/_async.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.comm import Comm
from . import _async
from ._base import SUM, OpLike, check_comm, combine_fn, fold, run_body
from ._fusion import materialize_value
from .allgather import _ReduceScatterSum
from .alltoall import _AllToAll
from .token import Token, produce


def reduce_scatter(x, op: OpLike = SUM, *, comm: Optional[Comm] = None,
                   token: Optional[Token] = None):
    """Reduce ``x`` (shape ``(size, *s)``) with ``op`` across all ranks of
    ``comm`` and scatter the result: rank i receives the reduction of every
    rank's ``x[i]``.  Returns ``(result, token)``."""
    lazy = _async.maybe_lazy("reduce_scatter", x, op, comm, token)
    if lazy is not None:
        return lazy
    comm = check_comm(comm, "reduce_scatter")
    return run_body("reduce_scatter", comm,
                    lambda c, a, t: (scatter_reduced(a[0], op, c), produce(t)),
                    (materialize_value(x),), token)


def scatter_reduced(x: torch.Tensor, op: OpLike, comm: Comm) -> torch.Tensor:
    """``reduce_scatter``'s result, run now on ``comm``."""
    size = comm.Get_size()
    if x.ndim == 0 or x.shape[0] != size:
        raise ValueError(
            f"reduce_scatter input must have leading axis == comm size "
            f"({size}), got shape {tuple(x.shape)} (block i is addressed to "
            "rank i, MPI_Reduce_scatter_block)"
        )
    fn = combine_fn(op)
    if size == 1:
        return x[0].clone()
    if op is SUM and x.dtype != torch.bool:
        return _ReduceScatterSum.apply(x, comm)
    out = fold(_AllToAll.apply(x, comm).unbind(0), fn)
    return out.to(torch.promote_types(out.dtype, x.dtype))
