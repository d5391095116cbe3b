"""allreduce: reduction across all ranks.

PyTorch counterpart of ``mpi4jax_tpu/ops/allreduce.py`` (its flat path,
``ops/_base.py:apply_allreduce``).  Every rank receives the reduction of
every rank's ``x``; on a color split, of its group's.  On a size-1 comm it
is a copy.  Over several ranks:

- SUM, MIN, MAX and PROD of a non-bool tensor: one ``dist.all_reduce``
  on the comm's process group, except PROD where autograd follows ``x``
  or on a color split (the fold below, the JAX package's association);
- every other reduction (the logical and bitwise ones, callables, bool
  tensors): one ``dist.all_gather`` of the blocks and the fold of the
  blocks in ascending group-rank order on every rank (``_base.fold``: the
  association of the JAX package's butterfly), so a callable that is
  associative but not commutative gives the same bits everywhere.  NCCL
  has no bitwise reductions and no bool reduction, so nothing here leans
  on ``dist.ReduceOp`` for them.

Each call is one exchange in ``ops/_staging.py``'s ``stats``.  Inside
``overlap()`` the call is split into ``allreduce_start`` and a wait
deferred to the result's first use (``ops/_async.py``); under fusion an
``Op`` reduction inside a region is queued and packed with its neighbours
(``ops/_fusion.py``); either returns a result that is computed on use.  The
result takes the JAX package's dtype: a logical reduction of bools is
bool, and of other dtypes the input's (its butterfly's ``jnp.where``
promotes the bool result); the bitwise ones keep the input dtype.

Autodiff.  Rank r's backward is seeded by rank r's own loss:

- SUM on a whole or grid comm: the backward is the per-rank identity
  (``_AllreduceSum``, whose backward is ``_Identity``, whose backward is
  ``_AllreduceSum`` again: a double backward is an allreduce and a triple
  one the identity, as the JAX package's double and triple
  ``linear_transpose``).  A replicated result counts once: the JAX
  package's transpose of ``psum`` with a replicated cotangent.
- SUM on a color split: the JAX package's butterfly result is
  rank-varying, and its transpose sums the group's cotangents, so the
  backward is the group's allreduce again (``_GroupSum``, its own
  transpose), as the fold's is.
- the fold: differentiable through the gather (``allgather.py``), whose
  backward sums every rank's cotangent back to the rank whose block it
  was: PROD and callables as the JAX package's butterfly transposes.
- MIN and MAX on a whole comm: the JAX package's ``pmin``/``pmax`` have no
  differentiation rule, so a grad request raises ``NotImplementedError``;
  with a grad on a color split they take the fold, differentiable, as the
  JAX package's butterfly is.

The forward mode reduces the tangent alongside (``jvp``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from . import _async, _fusion
from ._base import (SUM, Op, OpLike, check_comm, combine_fn, fold,
                    reduction_name, run_body)
from ._staging import Exchange
from .allgather import _AllGather
from .token import Token, produce

_DIST_OPS = {
    Op.SUM: dist.ReduceOp.SUM,
    Op.MIN: dist.ReduceOp.MIN,
    Op.MAX: dist.ReduceOp.MAX,
    Op.PROD: dist.ReduceOp.PRODUCT,
}


def all_reduce(x: torch.Tensor, op: Op, comm: Comm) -> torch.Tensor:
    """One ``dist.all_reduce`` of ``x`` (SUM, MIN, MAX or PROD) over ``comm``'s
    ranks; ``x`` is not written."""
    with Exchange(x.device) as ex:
        buf = ex.send(x)
        if buf.data_ptr() == x.data_ptr():  # all_reduce writes in place
            buf = buf.clone()
        dist.all_reduce(buf, op=_DIST_OPS[op], group=comm.group())
        return ex.result(buf)


class _AllreduceSum(torch.autograd.Function):
    """SUM-allreduce whose backward is the per-rank identity."""

    @staticmethod
    def forward(x, comm):
        return all_reduce(x, Op.SUM, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Identity.apply(g, ctx.comm), None

    @staticmethod
    def jvp(ctx, t, _):
        return all_reduce(t, Op.SUM, ctx.comm)


class _GroupSum(torch.autograd.Function):
    """SUM-allreduce on a color split: its own transpose."""

    @staticmethod
    def forward(x, comm):
        return all_reduce(x, Op.SUM, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _GroupSum.apply(g, ctx.comm), None

    @staticmethod
    def jvp(ctx, t, _):
        return all_reduce(t, Op.SUM, ctx.comm)


class _Identity(torch.autograd.Function):
    """The transpose of ``_AllreduceSum``; its own transpose is the
    allreduce again."""

    @staticmethod
    def forward(g, comm):
        return g.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def backward(ctx, gg):
        return _AllreduceSum.apply(gg, ctx.comm), None

    @staticmethod
    def jvp(ctx, t, _):
        return t


def wants_grad(x: torch.Tensor) -> bool:
    """Whether autograd, backward or forward, follows ``x`` here."""
    if torch.is_grad_enabled() and x.requires_grad:
        return True
    return torch.autograd.forward_ad.unpack_dual(x).tangent is not None


def allreduce(x, op: OpLike = SUM, *, comm: Optional[Comm] = None,
              token: Optional[Token] = None):
    """Reduce ``x`` with ``op`` across all ranks of ``comm``; every rank
    receives the result.  Returns ``(result, token)``."""
    # overlap first: a split collective already hides its latency
    lazy = _async.maybe_lazy("allreduce", x, op, comm, token)
    if lazy is not None:
        return lazy
    if isinstance(op, Op):  # callables never fuse
        deferred = _fusion.maybe_defer("allreduce", x, comm, token, reduction=op)
        if deferred is not None:
            return deferred
    comm = check_comm(comm, "allreduce")
    return run_body("allreduce", comm,
                    lambda c, a, t: (reduce_all(a[0], op, c), produce(t)),
                    (_fusion.materialize_value(x),), token,
                    ana={"reduction": reduction_name(op)})


def reduce_all(x: torch.Tensor, op: OpLike, comm: Comm) -> torch.Tensor:
    """``allreduce``'s result, run now on ``comm``."""
    fn = combine_fn(op)
    if len(comm.members()) == 1:
        return x.clone()
    split = comm.groups is not None
    if op in _DIST_OPS and x.dtype != torch.bool:
        if op is Op.SUM:
            return (_GroupSum if split else _AllreduceSum).apply(x, comm)
        grad = wants_grad(x)
        if not grad and not (split and op is Op.PROD):
            return all_reduce(x, op, comm)
        if grad and not split and op is not Op.PROD:
            raise NotImplementedError(
                f"allreduce: no derivative of {op.name} on a whole comm, as in "
                f"the JAX package, where lax.p{op.value} has no "
                "differentiation rule; reduce a detached tensor"
            )
    out = fold(_AllGather.apply(x, comm).unbind(0), fn)
    # the butterfly's jnp.where promotes a logical result to the input's dtype
    return out.to(torch.promote_types(out.dtype, x.dtype))
