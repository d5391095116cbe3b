"""recv: point-to-point receive half.

PyTorch counterpart of ``mpi4jax_tpu/ops/recv.py``.  ``x`` is a template
of the received shape and dtype.  The recv takes the oldest send queued on
its (comm, tag) by this rank (``ops/send.py``): ``source=None`` adopts that
send's routing, and an explicit ``source`` spec is checked against it.  A
recv with nothing queued raises MPX102 (MPI would block forever); a recv
that fails a check leaves the send queued, so a corrected retry matches it.
A rank with no source in the routing gets ``x`` back (MPI_PROC_NULL).

The pair is differentiable as ``sendrecv`` is: the received tensor's
cotangent goes back along the reverse route to the sender's ``x``
(``_SendRecv``), and the forward mode sends the tangent along the same
route when the recv runs.
"""

from __future__ import annotations

from typing import Optional

from ..parallel.comm import Comm
from ..analysis import hook as _analysis
from ..analysis.schedule import concretizing
from ._base import check_comm, meta_like, mpx_error, run_body
from .send import check_no_overtake, check_tag, queue
from .sendrecv import _SendRecv, fill_status, peers, routing
from .status import Status
from .token import Token, produce


def recv(x, source=None, tag: int = 0, *, comm: Optional[Comm] = None,
         status: Optional[Status] = None, token: Optional[Token] = None):
    """Receive into ``x``'s shape and dtype from the matching ``send``.
    Returns ``(received, token)``."""
    comm = check_comm(comm, "recv")
    if _analysis.recording():
        ana = abstract_match(x, source, tag, comm, status, "recv")
        return run_body("recv", comm, None, (x,), token, ana=ana,
                        abstract=lambda a, t: (meta_like(a[0]), produce(t)))
    pending = match(x, source, tag, comm, "recv")
    rank = comm.Get_rank()
    to, frm = pending.to, pending.frm
    fill_status(status, frm, tag, pending.x)

    def body(comm, arrays, token):
        (x,) = arrays
        if to is None and frm is None:
            return x, produce(token)
        if to == rank:  # a route onto itself
            pending.receive(x, None)
            return pending.x.reshape(x.shape).clone(), produce(token)
        received = _SendRecv.apply(
            pending.x, x, comm.global_rank(to) if to is not None else None,
            comm.global_rank(frm) if frm is not None else None, pending)
        return received, produce(token)

    return run_body("recv", comm, body, (x,), token)


def abstract_match(x, source, tag: int, comm: Comm, status, what: str) -> dict:
    """A recv of an abstract run (``analysis/``): its event's structure.
    A per-rank run records it one-sided (the routing of an explicit
    ``source``, else a wildcard the cross-rank matcher pairs); otherwise
    it matches the recorder's own queue as ``match`` matches the real one
    (MPX102, MPX106), and notes a queue of several sends (MPX110)."""
    check_tag(tag, what)
    if concretizing():
        if source is None:
            return {"tag": tag, "pairs": None}
        frm = peers(routing(comm, source, None, what), comm.Get_rank())[1]
        fill_status(status, frm, tag, x)
        return {"tag": tag,
                "pairs": _analysis.event_pairs(comm, source, None, what)}
    q = _analysis.current_recorder().queue(comm.uid, tag)
    depth = len(q)
    pending = match(x, source, tag, comm, what, q)
    fill_status(status, pending.frm, tag, pending.x)
    ana = {"tag": tag, "pairs": pending.event_pairs}
    if depth >= 2:
        ana["queue_depth"] = depth
    return ana


def match(x, source, tag: int, comm: Comm, what: str, q=None):
    """Pop and return the oldest send queued on ``(comm, tag)`` (or on
    ``q``) after checking it against the template ``x`` and the ``source``
    spec; a failed check leaves it queued."""
    check_tag(tag, what)
    if q is None:
        q = queue(comm, tag)
    if not q:
        raise mpx_error(
            RuntimeError, "MPX102",
            f"{what}(tag={tag}): no matching send queued on this comm. The "
            "matching send must come earlier on the same comm and tag (MPI "
            "would block here forever).",
        )
    pending = q[0]
    if source is not None:
        pairs = routing(comm, source, None, what)
        if pairs != pending.pairs:
            raise ValueError(
                f"{what}: source spec implies routing {pairs} but the matching "
                f"send declared {pending.pairs}"
            )
    sent = pending.x
    if sent.dtype != x.dtype or sent.numel() != x.numel():
        raise mpx_error(
            ValueError, "MPX106",
            f"{what}: template shape/dtype {tuple(x.shape)}/{x.dtype} does not "
            f"match sent {tuple(sent.shape)}/{sent.dtype} (shapes may differ "
            "only at equal element count; the output takes the template's)",
        )
    check_no_overtake(pending)
    q.popleft()
    return pending
