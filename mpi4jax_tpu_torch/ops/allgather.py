"""allgather: every rank's tensor to every rank.

PyTorch counterpart of ``mpi4jax_tpu/ops/allgather.py``, with its shape
contract: input ``s``, output ``(size, *s)`` in comm-rank order on every
rank.  On a color split ``size`` is the group size, which only uniform
groups have (``GroupComm.Get_size`` raises on unequal ones, as the JAX
package does).  Over several ranks it is one ``dist.all_gather`` on the
comm's process group, with its buffers from ``ops/_staging.py``.

Autodiff: ``_AllGather``'s backward is the SUM reduce-scatter of the
cotangent (rank s gets the sum over ranks of their cotangent's block s)
and ``_ReduceScatterSum``'s backward is the allgather, the adjoint pair
of the JAX package's ``all_gather``/``psum_scatter``; each differentiates
again through the other.  The forward mode applies the op to the tangent.
The reduce-scatter is an ``alltoall`` of the blocks and a sum of the
received rows in ascending comm-rank order (``_base.fold``), so every
backend runs it the same way.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from ._base import (REDUCED_BLOCKS, STACKED, Exchanged, check_comm, exchange,
                    fold, meta_like, run_body)
from ._staging import Exchange
from .alltoall import _exchange as _alltoall
from .token import Token, produce


def gather_blocks(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Every rank's ``x``, stacked in comm-rank order (several ranks)."""
    return exchange(lambda v: _gather_blocks(v, comm), STACKED, x)


def _gather_blocks(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    members = comm.members()
    with Exchange(x.device) as ex:
        parts = [ex.buffer(x) for _ in members]
        dist.all_gather(parts, ex.send(x), group=comm.group())
        # all_gather orders by group rank, i.e. by ascending global rank
        by_global = dict(zip(sorted(members), parts))
        return ex.result(torch.stack([by_global[g] for g in members]))


def reduce_scatter_sum(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Block i of the sum over ranks of ``x``, on comm rank i."""
    return fold(_alltoall(x, comm).unbind(0), torch.add)


class _AllGather(Exchanged):
    layout = STACKED

    @staticmethod
    def forward(x, comm):
        return gather_blocks(x, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatterSum.apply(g, ctx.comm), None

    @staticmethod
    def jvp(ctx, t, _):
        return gather_blocks(t, ctx.comm)


class _ReduceScatterSum(Exchanged):
    layout = REDUCED_BLOCKS

    @staticmethod
    def forward(x, comm):
        return reduce_scatter_sum(x, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllGather.apply(g, ctx.comm), None

    @staticmethod
    def jvp(ctx, t, _):
        return reduce_scatter_sum(t, ctx.comm)


def allgather_any(x, comm: Comm):
    """``allgather``'s result on any comm; a size-1 comm copies."""
    if len(comm.members()) == 1:
        return x.unsqueeze(0).clone()
    return _AllGather.apply(x, comm)


def allgather(x, *, comm: Optional[Comm] = None, token: Optional[Token] = None):
    """Gather ``x`` from every rank; every rank receives
    ``(size, *x.shape)``.  Returns ``(result, token)``."""
    comm = check_comm(comm, "allgather")
    size = comm.Get_size()  # the uniform group size, or the JAX package's error
    return run_body("allgather", comm,
                    lambda c, a, t: (allgather_any(a[0], c), produce(t)),
                    (x,), token, abstract=lambda a, t: (
                        meta_like(a[0], (size, *a[0].shape)), produce(t)))
