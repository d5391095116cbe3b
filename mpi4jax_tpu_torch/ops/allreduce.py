"""allreduce: reduction across all ranks.

PyTorch counterpart of ``mpi4jax_tpu/ops/allreduce.py`` (its flat path,
``ops/_base.py:apply_allreduce``), with the port's own copy of the JAX
package's ``Op`` enum.  Every rank receives the reduction of every
rank's ``x``.  On a size-1 comm it is a copy.  Over several ranks it is
one ``dist.all_reduce`` on the comm's process group (row, column and
other sub-comms included), with its buffer from ``ops/_staging.py`` as
``gather``'s are, and counted in its ``stats``.

Ported: ``SUM``, ``PROD``, ``MIN`` and ``MAX``.  The logical and bitwise
members, callable reductions, fusion, the async variants and autodiff
are ROADMAP Queue 1 item 1 and raise ``NotImplementedError``.  Autodiff
in particular is not a plain ``autograd.Function``: in the JAX package
the transpose of a SUM-allreduce is the identity on each rank, and its
JVP reduces the tangents alongside (``mpi4jax_tpu/ops/allreduce.py:9-13``).
"""

from __future__ import annotations

import enum
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from ._staging import Exchange
from .token import Token, produce


class Op(enum.Enum):
    """Reduction operations, the members of the JAX package's ``Op``."""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"
    LAND = "land"
    LOR = "lor"
    LXOR = "lxor"
    BAND = "band"
    BOR = "bor"
    BXOR = "bxor"


SUM = Op.SUM
PROD = Op.PROD
MIN = Op.MIN
MAX = Op.MAX

_DIST_OPS = {
    Op.SUM: dist.ReduceOp.SUM,
    Op.PROD: dist.ReduceOp.PRODUCT,
    Op.MIN: dist.ReduceOp.MIN,
    Op.MAX: dist.ReduceOp.MAX,
}

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 1)"


def allreduce(x, op: Op = SUM, *, comm: Optional[Comm] = None,
              token: Optional[Token] = None):
    """Reduce ``x`` with ``op`` across all ranks of ``comm``; every rank
    receives the result.  Returns ``(result, token)``."""
    if comm is None:
        raise ValueError("allreduce: pass comm= (no default communicator yet)")
    if not isinstance(op, Op):
        raise NotImplementedError(f"allreduce: a callable reduction {_NOT_PORTED}")
    if op not in _DIST_OPS:
        raise NotImplementedError(f"allreduce: op {op.name} {_NOT_PORTED}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"allreduce: autodiff {_NOT_PORTED}; reduce a detached tensor")
    if comm.Get_size() == 1:
        return x.clone(), produce(token)
    with Exchange(x.device) as ex:
        buf = ex.send(x)
        if buf.data_ptr() == x.data_ptr():  # all_reduce writes in place
            buf = buf.clone()
        dist.all_reduce(buf, op=_DIST_OPS[op], group=comm.group())
        out = ex.result(buf)
    return out, produce(token)
