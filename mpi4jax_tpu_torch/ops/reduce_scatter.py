"""reduce_scatter: reduce, then scatter one block per rank.

PyTorch counterpart of ``mpi4jax_tpu/ops/reduce_scatter.py``
(``MPI_Reduce_scatter_block``): every rank passes ``(size, *s)``, block i
addressed to rank i, and rank i receives the reduction of every rank's
block i, shape ``s``.  On a color split ``size`` is the uniform group
size (unequal groups raise, as in the JAX package).  The lowering is
picked as the JAX package picks it (``_algos.select_reduce_scatter``): the
port's own route, one ``alltoall`` of the blocks and the fold of the
received rows in ascending group-rank order (``_base.fold``), callables
included, serves the native route and the butterfly (the JAX butterfly's
bits); the ring and the two-level hierarchy are ``ops/_algos.py``'s and
``ops/_hierarchy.py``'s.  A logical reduction of a non-bool dtype keeps
that dtype on the port's route, as in ``allreduce``.

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
from ._base import (SUM, OpLike, check_comm, combine_fn, fold, lowered,
                    meta_like, reduction_name, run_body)
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
                    (materialize_value(x),), token,
                    ana={"reduction": reduction_name(op)},
                    abstract=lambda a, t: (_abstract(a[0], op, comm), produce(t)))


def _abstract(x: torch.Tensor, op: OpLike, comm: Comm) -> torch.Tensor:
    from ._algos import select_reduce_scatter

    if check_blocks(x, comm) > 1:
        select_reduce_scatter(x, op, comm)
    return meta_like(x, x.shape[1:])


def check_blocks(x: torch.Tensor, comm: Comm) -> int:
    """The comm size, after checking that ``x`` holds one block a rank."""
    size = comm.Get_size()
    if x.ndim == 0 or x.shape[0] != size:
        raise ValueError(
            f"reduce_scatter input must have leading axis == comm size "
            f"({size}), got shape {tuple(x.shape)} (block i is addressed to "
            "rank i, MPI_Reduce_scatter_block)"
        )
    return size


def scatter_reduced(x: torch.Tensor, op: OpLike, comm: Comm) -> torch.Tensor:
    """``reduce_scatter``'s result, run now on ``comm``."""
    from ._algos import apply_reduce_scatter, select_reduce_scatter

    size = check_blocks(x, comm)
    combine_fn(op)
    if size == 1:
        return x[0].clone()
    algo, plan = select_reduce_scatter(x, op, comm)
    if algo in ("ring", "hier"):
        return lowered(x, lambda v: apply_reduce_scatter(v, op, comm, algo, plan),
                       lambda v: own_route(v, op, comm))
    return own_route(x, op, comm)


def own_route(x: torch.Tensor, op: OpLike, comm: Comm) -> torch.Tensor:
    """The port's own differentiable reduce-scatter: the alltoall of the
    blocks and the ascending fold (SUM: ``_ReduceScatterSum``)."""
    fn = combine_fn(op)
    if op is SUM and x.dtype != torch.bool:
        return _ReduceScatterSum.apply(x, comm)
    out = fold(_AllToAll.apply(x, comm).unbind(0), fn)
    return out.to(torch.promote_types(out.dtype, x.dtype))
