"""send: point-to-point send half, and ``flush``.

PyTorch counterpart of ``mpi4jax_tpu/ops/send.py``.  ``send`` takes a
routing spec that reads the same on every rank (a bare int is refused,
MPX103) and never blocks: it starts this rank's message with
``dist.isend`` on a snapshot of ``x`` and queues the routing in a FIFO
per (comm, tag), the matching namespace: MPI's non-overtaking rule within
a channel.  The matching ``recv`` (``ops/recv.py``) pops the oldest entry
of its channel and receives this rank's own message; the send itself is
buffered (MPI_Bsend-like): nothing waits for it, its work and buffer are
kept until it completes (checked at every send, recv and barrier), and
``flush()`` waits for the rest.  So a ring of send-then-recv on every rank
never deadlocks, and neither do ranks that receive their channels in
different orders.  A send still queued at ``flush()`` raises MPX101, the
analog of the JAX package's unmatched send (and of a deadlock at
MPI_Finalize in MPI).

The wire tag folds the comm's ``uid`` into the user's tag, so messages on
two comms, or on a comm and its ``Clone``, never match each other on
gloo, which matches by tag.  NCCL ignores tags and delivers the messages
between two ranks in the order they were sent: there a ``recv`` that
would overtake an older queued message from the same rank on another
channel raises instead of taking the wrong message.  (The NCCL route
needs one GPU per rank and is untested.)
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from ..parallel.region import current_context
from ..analysis import hook as _analysis
from ..analysis.schedule import concretizing
from ._base import check_comm, mpx_error, refuse_rank_concrete, run_body
from ._fusion import flush_pending
from ._staging import Exchange
from .sendrecv import _p2p_ana, peers, routing
from .token import Token, produce

# a user tag takes the low 16 bits of the wire tag and the comm the rest,
# below 2**31 (gloo's limit)
TAG_LIMIT = 1 << 16
_UID_SLOTS = (1 << 15) - 1
_seq = itertools.count()
_queues: Dict[Tuple[int, int], deque] = {}
# (work, buffer) of every send whose recv ran but which may be in flight
_in_flight: List[Tuple[object, torch.Tensor]] = []


def wire_tag(comm: Comm, tag: int) -> int:
    """The tag a message of ``(comm, tag)`` carries; never 0, the tag of
    ``sendrecv``'s own messages."""
    return ((comm.uid % _UID_SLOTS) + 1) * TAG_LIMIT + tag


def check_tag(tag, what: str) -> None:
    refuse_rank_concrete(tag, "tag", what)
    if isinstance(tag, bool) or not isinstance(tag, int):
        raise TypeError(f"{what}: tag must be an int, got {type(tag).__name__}")
    if not 0 <= tag < TAG_LIMIT:
        raise ValueError(f"{what}: tag {tag} out of range [0, {TAG_LIMIT})")


def queue(comm: Comm, tag: int) -> deque:
    """The FIFO of ``(comm, tag)``."""
    return _queues.setdefault((comm.uid, tag), deque())


def drop_revoked() -> None:
    """Forget every queued and in-flight send: they belong to a world that
    an elastic shrink revoked (``resilience/elastic.py``), whose process
    group is gone."""
    _queues.clear()
    _in_flight.clear()


def reap() -> None:
    """Drop the sends that have completed (and their buffers)."""
    _in_flight[:] = [(w, b) for w, b in _in_flight if not w.is_completed()]


class PendingSend:
    """One queued send of this rank: its routing, its comm ranks ``to`` and
    ``frm`` (this rank's dest and source in it), the tensor it was given
    (``x``, which carries the autograd graph), and its message in flight."""

    def __init__(self, x, pairs, to, frm, wire, snapshot, work, seq, peer):
        self.x, self.pairs, self.to, self.frm = x, pairs, to, frm
        self.wire, self.seq, self.peer = wire, seq, peer
        self._snapshot, self._work = snapshot, work

    def receive(self, template: torch.Tensor, source: Optional[int]):
        """Receive this rank's message of the channel from global rank
        ``source`` (``None``: nothing arrives) into ``template``'s shape;
        this rank's own send is left to complete (``reap``)."""
        received = None
        if source is not None:
            with Exchange(template.device) as ex:
                buf = ex.buffer(template)
                dist.recv(buf, source, tag=self.wire)
                received = ex.result(buf)
        self.release()
        return received

    def release(self) -> None:
        """Hand this rank's own message over to ``reap`` (its recv ran)."""
        if self._work is not None:
            _in_flight.append((self._work, self._snapshot))
        self._snapshot = self._work = None
        reap()


def send(x, dest, tag: int = 0, *, comm: Optional[Comm] = None,
         token: Optional[Token] = None) -> Token:
    """Send ``x`` along the routing ``dest`` (e.g. ``shift(1)``); the
    matching ``recv`` on the same comm and tag receives it.  Returns a
    token."""
    comm = check_comm(comm, "send")
    check_tag(tag, "send")
    pairs = routing(comm, None, dest, "send")
    rank = comm.Get_rank()
    to, frm = peers(pairs, rank)

    def body(comm, arrays, token):
        (x,) = arrays
        wire, snapshot, work = wire_tag(comm, tag), None, None
        if to is not None and to != rank:
            with Exchange(x.device) as ex:
                snapshot = ex.send(x.detach())
                if snapshot.data_ptr() == x.data_ptr():
                    snapshot = snapshot.clone()
                work = dist.isend(snapshot, comm.global_rank(to), tag=wire)
        peer = comm.global_rank(frm) if frm is not None and frm != rank else None
        queue(comm, tag).append(PendingSend(x, pairs, to, frm, wire, snapshot,
                                            work, next(_seq), peer))
        reap()
        return produce(token)

    ana = _p2p_ana(comm, None, dest, tag, "send")

    def abstract(arrays, token):
        abstract_send(arrays[0], dest, tag, comm, ana["pairs"])
        return produce(token)

    return run_body("send", comm, body, (x,), token, ana=ana, abstract=abstract)


def abstract_send(x, dest, tag: int, comm: Comm, event_pairs) -> None:
    """A send of an abstract run (``analysis/``): queued on the
    recorder's own channel, where its recv pops it; a per-rank run records
    it one-sided, for the cross-rank matcher."""
    if concretizing():
        return
    pairs = routing(comm, None, dest, "send")
    to, frm = peers(pairs, comm.Get_rank())
    pending = PendingSend(x, pairs, to, frm, None, None, None, next(_seq), None)
    pending.event_pairs = event_pairs
    _analysis.current_recorder().queue(comm.uid, tag).append(pending)


def check_no_overtake(pending: PendingSend) -> None:
    """On NCCL, which matches point-to-point messages in order without
    tags, refuse a recv that would take a message from a rank that sent
    this rank an older one, still queued on another channel."""
    if pending.peer is None or dist.get_backend() != "nccl":
        return
    for key, q in _queues.items():
        older = [p for p in q if p.peer == pending.peer and p.seq < pending.seq]
        if older:
            raise RuntimeError(
                f"recv: global rank {pending.peer} sent this rank an older "
                f"message still queued on (comm uid, tag) {key}; NCCL delivers "
                "a pair's messages in order without tags, so receive that "
                "one first"
            )


def flush() -> None:
    """Issue the region's fusion queue (``ops/_fusion.py``); raise MPX101
    if a send is still unmatched (its recv can never come); else wait for
    every matched send to complete, and for the card's queued work."""
    flush_pending(current_context())
    leftover = {k: len(q) for k, q in _queues.items() if q}
    if not leftover:
        while _in_flight:
            _in_flight.pop()[0].wait()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if leftover:
        raise mpx_error(
            RuntimeError, "MPX101",
            f"unmatched send(s) at flush: {{(comm_uid, tag): count}} = "
            f"{leftover}. Every send must be matched by a recv on the same "
            "comm and tag before flush (in MPI a blocking send would "
            "deadlock here instead).",
        )
