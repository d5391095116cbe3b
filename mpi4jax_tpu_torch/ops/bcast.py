"""bcast: broadcast from root.

PyTorch counterpart of ``mpi4jax_tpu/ops/bcast.py``: every rank receives
root's value with the input's shape; root gets its own input back.
``root`` is a rank of the comm (of every group, on a color split), checked
with MPX105.  Over several ranks it is one ``dist.broadcast`` on the
comm's process group, with its buffer from ``ops/_staging.py``.

Autodiff (``_Bcast``): the backward sums the cotangents of every rank onto
root (``_ReduceToRoot``) and gives the other ranks zeros, the transpose of
the JAX package's masked ``psum``; with each rank's loss ``sum(y**2)``
root's gradient is ``2 * size * x_root``.  ``_ReduceToRoot``'s backward is
the broadcast again.  The forward mode broadcasts root's tangent.  Under
fusion, a bcast inside a region is queued and packed with its same-root
neighbours (``ops/_fusion.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from . import _fusion
from ._base import check_comm, check_root, run_body
from ._staging import Exchange
from .token import Token, produce


def broadcast(x: torch.Tensor, root: int, comm: Comm) -> torch.Tensor:
    """Comm rank ``root``'s ``x`` on every rank; ``x`` is not written."""
    with Exchange(x.device) as ex:
        buf = ex.send(x)
        if buf.data_ptr() == x.data_ptr():  # broadcast writes in place
            buf = buf.clone()
        dist.broadcast(buf, src=comm.global_rank(root), group=comm.group())
        return ex.result(buf)


def reduce_to_root(x: torch.Tensor, root: int, comm: Comm) -> torch.Tensor:
    """The sum of every rank's ``x`` on comm rank ``root``, zeros elsewhere."""
    with Exchange(x.device) as ex:
        buf = ex.send(x)
        if buf.data_ptr() == x.data_ptr():  # reduce writes in place
            buf = buf.clone()
        dist.reduce(buf, dst=comm.global_rank(root), op=dist.ReduceOp.SUM,
                    group=comm.group())
        out = ex.result(buf)
    return out if comm.Get_rank() == root else torch.zeros_like(x)


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(x, root, comm):
        return broadcast(x, root, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.root, ctx.comm = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _ReduceToRoot.apply(g, ctx.root, ctx.comm), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return broadcast(t, ctx.root, ctx.comm)


class _ReduceToRoot(torch.autograd.Function):
    @staticmethod
    def forward(x, root, comm):
        return reduce_to_root(x, root, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.root, ctx.comm = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Bcast.apply(g, ctx.root, ctx.comm), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return reduce_to_root(t, ctx.root, ctx.comm)


def bcast(x, root: int, *, comm: Optional[Comm] = None,
          token: Optional[Token] = None):
    """Broadcast ``x`` from rank ``root`` to all ranks.  Returns
    ``(result, token)``."""
    deferred = _fusion.maybe_defer("bcast", x, comm, token, root=root)
    if deferred is not None:
        return deferred
    comm = check_comm(comm, "bcast")
    check_root(root, comm.min_size(), "bcast")

    def body(comm, arrays, token):
        (x,) = arrays
        if len(comm.members()) == 1:
            return x.clone(), produce(token)
        return _Bcast.apply(x, root, comm), produce(token)

    return run_body("bcast", comm, body, (_fusion.materialize_value(x),), token,
                    ana={"root": root})
