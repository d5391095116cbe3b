"""sendrecv: paired exchange — the halo-exchange workhorse.

PyTorch counterpart of ``mpi4jax_tpu/ops/sendrecv.py``.  One matched send
and receive per rank, described by a static routing spec (``shift``, a
dict or pairs).  A rank with no source in the routing gets its ``recvbuf``
template back (MPI_PROC_NULL semantics).  This slice runs the size-1 comm,
where a wrapping route is the identity (the rank receives what it sent)
and a non-wrapping one delivers nothing.
"""

from __future__ import annotations

from typing import Optional

from ..parallel.comm import Comm
from ..parallel.mesh import MULTI_RANK_ITEM
from ..parallel.rankspec import resolve_routing
from ._base import check_send_recv
from .token import Token, produce


def sendrecv(sendbuf, recvbuf, source=None, dest=None, *,
             sendtag: int = 0, recvtag: int = 0,
             comm: Optional[Comm] = None, token: Optional[Token] = None):
    """Send ``sendbuf`` along the routing and receive into ``recvbuf``'s
    shape.  ``dest`` maps sender to receiver (e.g. ``shift(1)``);
    ``source`` is the receiver-centric view of the same pattern.  Returns
    ``(received, token)``.  Tags are accepted for API parity and, as in the
    JAX package, do not take part in matching."""
    if comm is None:
        raise ValueError("sendrecv: pass comm= (no default communicator yet)")
    check_send_recv(sendbuf, recvbuf, "sendrecv")
    size = comm.Get_size()
    pairs = resolve_routing(source, dest, size, what="sendrecv")
    if size != 1:
        raise NotImplementedError(
            f"sendrecv over {size} ranks needs process groups; see "
            f"{MULTI_RANK_ITEM}"
        )
    rank = comm.Get_rank()
    if any(d == rank for _, d in pairs):
        received = sendbuf.reshape(recvbuf.shape).clone()
    else:
        received = recvbuf
    return received, produce(token)
