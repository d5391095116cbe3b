"""sendrecv: paired exchange — the halo-exchange workhorse.

PyTorch counterpart of ``mpi4jax_tpu/ops/sendrecv.py``.  One matched send
and receive per rank, described by a static routing spec (``shift``, a
dict or pairs) that reads the same on every rank.  A rank with no source
in the routing gets its ``recvbuf`` template back (MPI_PROC_NULL
semantics).  On a size-1 comm a wrapping route is the identity (the rank
receives what it sent) and a non-wrapping one delivers nothing.  On a
color split (``GroupComm``) the spec is read in group ranks, at each
group's own size, so ``shift`` gives every group its own ring even when
the groups' sizes differ.

Over several ranks, this rank's peers come from the routing, translated
from comm ranks to global ranks, and one ``dist.batch_isend_irecv`` on the
default group carries the send and the receive.  The buffers come from
``ops/_staging.py``: contiguous, staged through pinned host memory on
gloo, and counted in its ``stats``.  The result is a fresh tensor that
never aliases the send buffer.

Autodiff (``_SendRecv``): the reverse mode sends the cotangent along the
reverse route (source and dest swapped), so rank s's ``sendbuf`` gets the
cotangent of the rank it sent to, and a rank without a dest gets zeros;
``recvbuf`` gets the cotangent where no message arrived.  The backward is
itself a ``_SendRecv``, so it differentiates again.  The forward mode
(``torch.autograd.forward_ad``, through the Function's ``jvp``) sends the
tangent along the same route, right after the primal, so every rank must
call it with a tangent.  Every rank that sends or receives must also run
the op's backward: a rank that drops the output of a sendrecv it took part
in leaves its peer's cotangent unreceived.  ``status=`` is filled as in
the JAX package: the source's comm rank (-1 where nothing arrived), the
tag the message was sent with, its element count and dtype.  Under
``torch.func.vmap`` the message is batched as the sent tensor is, the
batch dim first (``message_layout``), on every rank alike whether it
sends or not; an unbatched recv template beside it is expanded.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from ..parallel.rankspec import resolve_routing
from ..analysis import hook as _analysis
from ._base import (Exchanged, batch_at, check_comm, check_send_recv, exchange,
                    meta_like, run_body)
from ._staging import Exchange
from .status import Status
from .token import Token, produce


def routing(comm: Comm, source, dest, what: str):
    """(src, dst) pairs in comm ranks of this rank's group.  On a color
    split every group's size is checked, so a spec that names a rank some
    group lacks fails on every rank."""
    size = len(comm.members())
    if comm.groups is not None:
        for n in sorted({len(g) for g in comm.groups} - {size}):
            resolve_routing(source, dest, n, what=what)
    return resolve_routing(source, dest, size, what=what)


def peers(pairs, rank: int):
    """(dest, source) of ``rank`` in ``pairs``, each ``None`` if absent."""
    to = next((d for s, d in pairs if s == rank), None)
    frm = next((s for s, d in pairs if d == rank), None)
    return to, frm


def _exchange(send: Optional[torch.Tensor], dest: Optional[int],
              recv_like: Optional[torch.Tensor], source: Optional[int]):
    """Send ``send`` to global rank ``dest`` and receive a tensor shaped
    like ``recv_like`` from global rank ``source`` (``dest``, ``source``,
    ``recv_like`` may be ``None``: no send, no receive), as one batch of
    point-to-point ops; returns the received tensor (or ``None``).  Under
    ``vmap`` the message is batched as ``send`` is (as ``recv_like`` is
    where there is no ``send``): every rank's program batches it alike,
    whether or not this rank sends."""
    return exchange(lambda s, r: _p2p(s, dest, r, source), message_layout,
                    send, recv_like)


def message_layout(size, in_dims, args):
    """The ``vmap`` layout of a point-to-point exchange ``(send,
    recv_like)`` (see ``_exchange``): a batched message with the batch dim
    first, the other buffer expanded to it; an unbatched message is
    received into one lane of ``recv_like``."""
    send, recv_like = args
    lead = in_dims[0] if send is not None else in_dims[1]
    if lead is None:
        return [send, recv_like.select(in_dims[1], 0)], None
    return [None if t is None else batch_at(size, d, t)
            for t, d in zip(args, in_dims)], 0


def _p2p(send, dest, recv_like, source):
    device = (recv_like if recv_like is not None else send).device
    with Exchange(device) as ex:
        ops, recv = [], None
        if send is not None and dest is not None:
            ops.append(dist.P2POp(dist.isend, ex.send(send), dest))
        if recv_like is not None:
            recv = ex.buffer(recv_like)
            ops.append(dist.P2POp(dist.irecv, recv, source))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return None if recv is None else ex.result(recv)


class _SendRecv(Exchanged):
    """One rank's part of a routed exchange: send ``sendbuf`` to global rank
    ``to`` and receive from ``frm`` (either ``None``); the output is the
    received tensor, or a copy of ``recvbuf`` where nothing arrives.
    ``pending`` is a queued ``send`` (``ops/send.py``) whose message is
    already on its way: the forward then only receives and completes it.
    Under ``vmap`` the message is batched as ``sendbuf`` is
    (``message_layout``)."""

    @staticmethod
    def forward(sendbuf, recvbuf, to, frm, pending):
        if pending is not None:
            received = pending.receive(recvbuf, frm)
        else:
            received = _exchange(sendbuf.reshape(recvbuf.shape), to,
                                 recvbuf if frm is not None else None, frm)
        return received if received is not None else recvbuf.clone()

    @staticmethod
    def vmap(info, in_dims, sendbuf, recvbuf, to, frm, pending):
        (send, recv), out = message_layout(info.batch_size, in_dims[:2],
                                           (sendbuf, recvbuf))
        received = _SendRecv.apply(send, recv, to, frm, pending)
        if frm is None and out is None:  # nothing arrives: recvbuf's lanes
            return recvbuf.clone(), in_dims[1]
        return received, out

    @staticmethod
    def setup_context(ctx, inputs, output):
        sendbuf, recvbuf, to, frm, _ = inputs
        ctx.to, ctx.frm = to, frm
        ctx.send_shape, ctx.recv_shape = sendbuf.shape, recvbuf.shape
        ctx.like = {"dtype": sendbuf.dtype, "device": sendbuf.device}

    @staticmethod
    def backward(ctx, g):
        # the reverse route: the cotangent goes back to the source, and
        # this rank's sendbuf gets what its dest sends back (zeros if none)
        back = g.reshape(ctx.send_shape)
        grad_send = _SendRecv.apply(back, torch.zeros_like(back), ctx.frm,
                                    ctx.to, None)
        grad_recv = g if ctx.frm is None else None
        return grad_send, grad_recv, None, None, None

    @staticmethod
    def jvp(ctx, t_send, t_recv, *_):
        # the tangent takes the primal's route; where nothing arrives, the
        # output is recvbuf and so is its tangent
        if t_send is None:
            t_send = torch.zeros(ctx.send_shape, **ctx.like)
        received = _exchange(
            t_send.reshape(ctx.recv_shape), ctx.to,
            torch.empty(ctx.recv_shape, **ctx.like) if ctx.frm is not None else None,
            ctx.frm)
        if received is not None:
            return received
        return t_recv if t_recv is not None else torch.zeros(ctx.recv_shape,
                                                             **ctx.like)


def fill_status(status: Optional[Status], frm: Optional[int], tag: int,
                sent: torch.Tensor) -> None:
    """The received message's source (comm rank, -1 for none), tag, element
    count and dtype."""
    if status is None:
        return
    status.source = -1 if frm is None else frm
    status.tag = tag
    status.count = sent.numel()
    status.dtype = sent.dtype


def sendrecv(sendbuf, recvbuf, source=None, dest=None, *,
             sendtag: int = 0, recvtag: int = 0,
             comm: Optional[Comm] = None, status: Optional[Status] = None,
             token: Optional[Token] = None):
    """Send ``sendbuf`` along the routing and receive into ``recvbuf``'s
    shape.  ``dest`` maps sender to receiver (e.g. ``shift(1)``);
    ``source`` is the receiver-centric view of the same pattern.  Returns
    ``(received, token)``.  Tags are accepted for API parity and, as in the
    JAX package, do not take part in matching: the message always comes
    from this call, and ``status.tag`` is ``sendtag``."""
    comm = check_comm(comm, "sendrecv")
    check_send_recv(sendbuf, recvbuf, "sendrecv")
    pairs = routing(comm, source, dest, "sendrecv")
    rank = comm.Get_rank()
    to, frm = peers(pairs, rank)
    fill_status(status, frm, sendtag, sendbuf)

    def body(comm, arrays, token):
        sendbuf, recvbuf = arrays
        if frm is None and to is None:
            return recvbuf, produce(token)
        if frm == rank and to == rank:  # a route onto itself: no message
            return sendbuf.reshape(recvbuf.shape).clone(), produce(token)
        received = _SendRecv.apply(
            sendbuf, recvbuf,
            comm.global_rank(to) if to is not None else None,
            comm.global_rank(frm) if frm is not None else None, None)
        return received, produce(token)

    return run_body("sendrecv", comm, body, (sendbuf, recvbuf), token,
                    ana=_p2p_ana(comm, source, dest, sendtag, "sendrecv"),
                    abstract=lambda a, t: (meta_like(a[1]), produce(t)))


def _p2p_ana(comm: Comm, source, dest, tag: int, what: str):
    """A point-to-point op's static structure for the verifier: its tag
    and, while an abstract run records, its routing pairs as the JAX
    package records them (``analysis/hook.py:event_pairs``)."""
    if not _analysis.recording():
        return {"tag": tag}
    return {"tag": tag, "pairs": _analysis.event_pairs(comm, source, dest, what)}
