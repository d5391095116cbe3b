"""sendrecv: paired exchange — the halo-exchange workhorse.

PyTorch counterpart of ``mpi4jax_tpu/ops/sendrecv.py``.  One matched send
and receive per rank, described by a static routing spec (``shift``, a
dict or pairs) that reads the same on every rank.  A rank with no source
in the routing gets its ``recvbuf`` template back (MPI_PROC_NULL
semantics).  On a size-1 comm a wrapping route is the identity (the rank
receives what it sent) and a non-wrapping one delivers nothing.

Over several ranks, this rank's peers come from the routing, translated
from comm ranks to global ranks, and one ``dist.batch_isend_irecv`` on the
default group carries the send and the receive.  The buffers come from
``ops/_staging.py``: contiguous, staged through pinned host memory on
gloo, and counted in its ``stats``.  The result is a fresh tensor that
never aliases the send buffer.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from ..parallel.rankspec import resolve_routing
from ._base import check_send_recv
from ._staging import Exchange
from .token import Token, produce


def _exchange(send: Optional[torch.Tensor], dest: Optional[int],
              recv_like: Optional[torch.Tensor], source: Optional[int]):
    """Send ``send`` to global rank ``dest`` and receive a tensor shaped
    like ``recv_like`` from global rank ``source`` (either may be ``None``),
    as one batch of point-to-point ops; returns the received tensor (or
    ``None``)."""
    device = (recv_like if recv_like is not None else send).device
    with Exchange(device) as ex:
        ops, recv = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, ex.send(send), dest))
        if recv_like is not None:
            recv = ex.buffer(recv_like)
            ops.append(dist.P2POp(dist.irecv, recv, source))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return None if recv is None else ex.result(recv)


def sendrecv(sendbuf, recvbuf, source=None, dest=None, *,
             sendtag: int = 0, recvtag: int = 0,
             comm: Optional[Comm] = None, token: Optional[Token] = None):
    """Send ``sendbuf`` along the routing and receive into ``recvbuf``'s
    shape.  ``dest`` maps sender to receiver (e.g. ``shift(1)``);
    ``source`` is the receiver-centric view of the same pattern.  Returns
    ``(received, token)``.  Tags are accepted for API parity and, as in the
    JAX package, do not take part in matching: messages between two ranks
    are received in the order they were sent."""
    if comm is None:
        raise ValueError("sendrecv: pass comm= (no default communicator yet)")
    check_send_recv(sendbuf, recvbuf, "sendrecv")
    size = comm.Get_size()
    pairs = resolve_routing(source, dest, size, what="sendrecv")
    rank = comm.Get_rank()
    to = next((d for s, d in pairs if s == rank), None)
    frm = next((s for s, d in pairs if d == rank), None)
    if frm is None and to is None:
        return recvbuf, produce(token)
    if frm == rank and to == rank:  # a route onto itself: no message
        return sendbuf.reshape(recvbuf.shape).clone(), produce(token)
    received = _exchange(
        sendbuf.reshape(recvbuf.shape) if to is not None else None,
        comm.global_rank(to) if to is not None else None,
        recvbuf if frm is not None else None,
        comm.global_rank(frm) if frm is not None else None,
    )
    return (received if received is not None else recvbuf), produce(token)
