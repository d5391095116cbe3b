"""The tokenless API: every op returns only its data.

PyTorch counterpart of ``mpi4jax_tpu/experimental/notoken.py``: all 13
ops, each the main op with ``token=None`` and its token dropped; ``send``
and ``barrier`` return ``None``.  Eager PyTorch runs every op in program
order, so nothing is lost by dropping the token.
"""

from __future__ import annotations

from typing import Optional

from .. import ops as _ops
from ..ops import SUM, OpLike, Status
from ..parallel.comm import Comm


def allreduce(x, op: OpLike = SUM, *, comm: Optional[Comm] = None):
    return _ops.allreduce(x, op, comm=comm)[0]


def allgather(x, *, comm: Optional[Comm] = None):
    return _ops.allgather(x, comm=comm)[0]


def alltoall(x, *, comm: Optional[Comm] = None):
    return _ops.alltoall(x, comm=comm)[0]


def barrier(*, comm: Optional[Comm] = None) -> None:
    _ops.barrier(comm=comm)


def bcast(x, root: int, *, comm: Optional[Comm] = None):
    return _ops.bcast(x, root, comm=comm)[0]


def gather(x, root: int, *, comm: Optional[Comm] = None):
    return _ops.gather(x, root, comm=comm)[0]


def recv(x, source=None, tag: int = 0, *, comm: Optional[Comm] = None,
         status: Optional[Status] = None):
    return _ops.recv(x, source, tag, comm=comm, status=status)[0]


def reduce(x, op: OpLike, root: int, *, comm: Optional[Comm] = None):
    return _ops.reduce(x, op, root, comm=comm)[0]


def reduce_scatter(x, op: OpLike = SUM, *, comm: Optional[Comm] = None):
    return _ops.reduce_scatter(x, op, comm=comm)[0]


def scan(x, op: OpLike = SUM, *, comm: Optional[Comm] = None):
    return _ops.scan(x, op, comm=comm)[0]


def scatter(x, root: int, *, comm: Optional[Comm] = None):
    return _ops.scatter(x, root, comm=comm)[0]


def send(x, dest, tag: int = 0, *, comm: Optional[Comm] = None) -> None:
    _ops.send(x, dest, tag, comm=comm)


def sendrecv(sendbuf, recvbuf, source=None, dest=None, *, sendtag: int = 0,
             recvtag: int = 0, comm: Optional[Comm] = None,
             status: Optional[Status] = None):
    return _ops.sendrecv(sendbuf, recvbuf, source, dest, sendtag=sendtag,
                         recvtag=recvtag, comm=comm, status=status)[0]
