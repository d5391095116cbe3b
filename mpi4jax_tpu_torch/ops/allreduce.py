"""allreduce: reduction across all ranks.

PyTorch counterpart of ``mpi4jax_tpu/ops/allreduce.py`` and its lowering
(``ops/_base.py:apply_allreduce``).  Every rank receives the reduction of
every rank's ``x``; on a color split, of its group's.  On a size-1 comm it
is a copy.  Over several ranks the lowering is picked per call as the
JAX package picks it (``select_allreduce``, ``MPI4JAX_TPU_COLLECTIVE_ALGO``):

- ``native``, under ``auto`` for SUM, MIN and MAX on a whole comm: one
  ``dist.all_reduce`` on the comm's process group (the JAX package's
  ``psum``/``pmin``/``pmax``; a bool tensor takes the fold below);
- ``butterfly``: one ``dist.all_gather`` of the blocks and the fold in
  ascending group-rank order on every rank (``_base.fold``: the
  association of the JAX package's butterfly), so a callable that is
  associative but not commutative gives the same bits everywhere, the
  JAX package's; NCCL has no bitwise and no bool reduction, so nothing
  here leans on ``dist.ReduceOp`` for them;
- ``ring`` and ``hier``: the ring and two-level lowerings of
  ``ops/_algos.py`` and ``ops/_hierarchy.py``, the JAX lowerings' bits.

Each exchange is one in ``ops/_staging.py``'s ``stats`` (a ring round is
one).  Inside ``overlap()`` the call is split into ``allreduce_start`` and
a wait deferred to the result's first use (``ops/_async.py``); under
fusion an ``Op`` reduction inside a region is queued and packed with its
neighbours (``ops/_fusion.py``); either returns a result that is computed
on use.  The result takes the JAX package's dtype for its lowering: the
butterfly's logical reduction of bools is bool, of other dtypes the
input's (its ``jnp.where`` promotes the bool result); through the ring a
logical reduction is bool; the bitwise ones keep the input dtype.

Autodiff.  The lowering changes the forward only (``_base.lowered``):
the backward is the op's own route's.  Rank r's backward is seeded by
rank r's own loss:

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

The forward mode reduces the tangent alongside (``jvp``).  Under
``torch.func`` every exchange here batches through its Function's
``vmap`` rule (``_base.Exchanged``): a vmapped allreduce is one
collective, a callable folds lane by lane, and ``jacrev``/``jacfwd``
batch the backward and jvp rules in the same way; ``wants_grad`` sees
the grad and jvp levels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..analysis.hook import dtype_name
from ..parallel.comm import Comm
from ..utils import config
from . import _async, _fusion
from ._base import (ELEMENTWISE, SUM, Exchanged, Op, OpLike, annotate_native,
                    check_comm, combine_fn, exchange, fold, lowered, meta_like,
                    reduction_name, run_body, wants_grad)
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
    return exchange(lambda v: _all_reduce(v, op, comm), ELEMENTWISE, x)


def _all_reduce(x: torch.Tensor, op: Op, comm: Comm) -> torch.Tensor:
    with Exchange(x.device) as ex:
        buf = ex.send(x)
        if buf.data_ptr() == x.data_ptr():  # all_reduce writes in place
            buf = buf.clone()
        dist.all_reduce(buf, op=_DIST_OPS[op], group=comm.group())
        return ex.result(buf)


class _AllreduceSum(Exchanged):
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


class _GroupSum(Exchanged):
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


class _Identity(Exchanged):
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
    combine_fn(op)
    return run_body("allreduce", comm,
                    lambda c, a, t: (reduce_all(a[0], op, c), produce(t)),
                    (_fusion.materialize_value(x),), token,
                    ana={"reduction": reduction_name(op)},
                    abstract=lambda a, t: (abstract_allreduce(a[0], op, comm),
                                           produce(t)))


# the reductions with a native collective (the JAX package's psum, pmin,
# pmax), which ``auto`` keeps on a whole comm
_NATIVE = (Op.SUM, Op.MIN, Op.MAX)


def select_allreduce(x: torch.Tensor, op: OpLike, comm: Comm):
    """The lowering of an allreduce of ``x``, as the JAX package's
    ``apply_allreduce`` picks it: ``(algo, plan, k)``, ``algo`` one of
    ``native``, ``butterfly``, ``ring``, ``hier``; annotated on the open
    verifier event and telemetry record.  Runs in abstract runs too."""
    from . import _algos, _hierarchy

    algo = config.collective_algo()
    if algo == "auto" and comm.groups is None and op in _NATIVE:
        annotate_native()
        return "native", None, None
    k = _algos.static_group_size(comm)
    chunk_ok = isinstance(op, Op) or algo in ("ring", "hier")
    ring_ok = k is not None and k > 1 and (
        isinstance(op, Op) or algo == "ring")  # auto never chunks callables
    plan = _hierarchy.hier_plan(comm) if k is not None and k > 1 else None
    nbytes = x.numel() * x.element_size()
    picked = _algos.resolve_algo(algo, nbytes, k or 1, ring_ok,
                                 hier_ok=plan is not None and chunk_ok)
    # a callable under auto never reaches the hierarchy: MPX113 must not
    # advise a choice this call does not have
    _hierarchy.annotate_selection(
        "allreduce", picked, nbytes, k or 1, plan if chunk_ok else None,
        comm, preserve=not isinstance(op, Op), op=op,
        dtype=dtype_name(x.dtype))
    return picked, plan, k


def abstract_allreduce(x: torch.Tensor, op: OpLike, comm: Comm) -> torch.Tensor:
    """An abstract run's allreduce: the selection, annotated, and a
    ``meta`` result."""
    if len(comm.members()) > 1:
        select_allreduce(x, op, comm)
    return meta_like(x)


def reduce_all(x: torch.Tensor, op: OpLike, comm: Comm) -> torch.Tensor:
    """``allreduce``'s result, run now on ``comm``."""
    if len(comm.members()) == 1:
        return x.clone()
    algo, plan, k = select_allreduce(x, op, comm)
    return run_allreduce(x, op, comm, algo, plan, k)


def run_allreduce(x: torch.Tensor, op: OpLike, comm: Comm, algo: str, plan,
                  k) -> torch.Tensor:
    """Run the lowering ``select_allreduce`` picked."""
    from . import _algos, _hierarchy

    if algo == "native":
        return own_route(x, op, comm)
    if algo == "hier":
        run = lambda v: _hierarchy.apply_hier_allreduce(v, op, comm, plan)
    elif algo == "ring":
        run = lambda v: _algos.apply_ring_allreduce(v, op, comm, k)
    else:
        run = lambda v: _algos.apply_butterfly_allreduce(v, op, comm)
    return lowered(x, run, lambda v: own_route(v, op, comm))


def own_route(x: torch.Tensor, op: OpLike, comm: Comm) -> torch.Tensor:
    """The port's own differentiable allreduce: ``dist.all_reduce`` for
    SUM, MIN, MAX and PROD of a non-bool tensor (the fold for PROD under
    autograd or on a color split), the gather and fold otherwise."""
    fn = combine_fn(op)
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
