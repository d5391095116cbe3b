"""Async collectives: ``*_start``/``*_wait`` pairs and ``overlap()``.

PyTorch counterpart of ``mpi4jax_tpu/ops/_async.py``.  A start issues the
exchange and returns a handle at once; compute issued before the wait
runs while the exchange is on the wire; the wait finishes it and returns
the result.  The JAX package splits a collective into ring phases that
its scheduler interleaves with compute; here a start issues
``torch.distributed`` work with ``async_op=True``:

- ``allreduce_start`` flattens the payload, splits it into
  ``MPI4JAX_TPU_OVERLAP_CHUNKS`` pieces (``overlap_chunk_split``) and
  issues one ``dist.all_reduce`` a piece; ``allreduce_wait`` waits for
  each and reassembles the input's shape.  Where the JAX package's
  selector takes the two-level lowering (a comm of several hosts,
  ``ops/_hierarchy.py``), and under a forced ``ring``, each piece instead
  runs its ring reduce-scatter (and the hierarchy's inter-host exchange)
  at the start and its ring allgather at the wait, the JAX package's
  chunked split; under ``auto`` without a plan the port keeps its
  ``dist.all_reduce`` pieces where the JAX package rings (ROADMAP,
  Queue 3);
- ``alltoall_start`` and ``reduce_scatter_start`` split every block along
  its payload and issue one ``dist.all_to_all_single`` a piece; the waits
  reassemble, and ``reduce_scatter_wait`` folds the received rows in
  ascending rank order as the synchronous op does.  Where the selector
  takes the hierarchical alltoall, each piece runs it at the start;
- ``send_start`` queues a buffered send as ``send`` does; ``recv_start``
  takes the matching send and posts a ``dist.irecv``; ``p2p_wait``
  returns the received tensor (a send's handle returns its payload).

On gloo a CUDA tensor is staged through a pinned host buffer
(``ops/_staging.py``), which the handle keeps alive until the wait copies
it back to the device; other backends get the tensor, and the wait makes
the current stream wait for the work (the NCCL route, which needs one GPU
a rank, is written and has not run).  Outstanding works on one process
group are matched by issue order, so handles may be waited in any order.

Where the async route does not give the synchronous op's bits or its
autograd (a size-1 comm, a reduction the port folds itself: callables,
bool tensors, the logical and bitwise ones, PROD on a color split; a
tensor that autograd follows, forward or backward, or that a
``torch.func`` transform wraps), the start runs the whole synchronous op
and the wait only returns its result, as the JAX package's start does
where its ring does not apply.  An f32 SUM or PROD
in pieces may add in another order than in one piece: fused, chunked and
whole results agree within the band the port's SUM is held to (rtol
1e-5); everything else bit for bit.

A start needs a region (``parallel/region.py``); a handle waited twice
raises MPX112, and so does a start its region never waited, at the
region's end.  Inside a megastep loop (``parallel/megastep.py``) a start
records its iteration, and its span must close there: a start still in
flight at the iteration's end raises MPX130 (``close_iteration``), and so
does a wait of a start from another iteration or from outside the loop.
``with overlap():`` splits every ``allreduce``, ``reduce_scatter`` and
``alltoall`` inside it into a start and a wait deferred to the result's
first use (``_LazyWait``), or to the scope's end; under a ``torch.func``
transform that began inside the region the op runs at once
(``_fusion.deferrable``).

Each start and each wait goes through the dispatch point as its own op
(``ops/_base.py:run_body``, ``bare=True``: a telemetry record each), and
the pair carries one instrumentation span, as in the JAX package: the
start runs the fault probe, the input guards, the watchdog arm, the
events-tier journal begin and the trace's begin line of the base op
(``allreduce``, ``send``, ...); the wait, or the region or iteration end
that collects a start left in flight, runs the trace's end line, the
journal end, the disarm and the output guards (``_span_open``,
``_span_close``).
"""

from __future__ import annotations

import itertools
from typing import List, Optional

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from ..parallel.region import current_context
from ..utils import config
from . import _fusion
from ..analysis import hook as _analysis
from ._base import (SUM, Op, check_comm, combine_fn, fold, meta_like, mpx_error,
                    reduction_name, run_body, transformed, wants_grad)
from ._staging import Exchange
from .recv import match, recv
from .send import queue, send
from .token import Token, produce

_span_counter = itertools.count()


def overlap_chunk_split(n: int, chunks: int) -> List[int]:
    """Chunk element counts for an ``n``-element payload: at most
    ``chunks`` pieces of ``ceil(n / chunks)`` but the last, none empty,
    summing to ``n``."""
    if n <= 0:
        return [n]
    c = max(1, min(int(chunks), n))
    stride = -(-n // c)
    sizes, left = [], n
    while left > 0:
        take = min(stride, left)
        sizes.append(take)
        left -= take
    return sizes


class AsyncHandle:
    """One started collective: ``mode`` is ``"async"`` (works in flight in
    ``pieces``), ``"full"`` (the result in ``pieces``, computed at the
    start), or ``"ring"``/``"hier"`` (each piece's reduce-scatter phase in
    ``pieces``, its allgather phase left to the wait)."""

    __slots__ = ("kind", "comm", "reduction", "shape", "dtype", "device",
                 "sizes", "k", "mode", "pieces", "uid", "waited", "exchange",
                 "order", "loop", "span", "piece", "plan")

    def __init__(self, kind, comm, reduction):
        self.kind = kind
        self.comm = comm
        self.reduction = reduction
        self.shape = self.dtype = self.device = None
        self.sizes = self.k = self.mode = self.pieces = None
        self.exchange = self.order = self.plan = None
        self.uid = next(_span_counter)
        self.waited = False
        # (loop id, iteration) of the megastep iteration it started in
        self.loop = None
        # the instrumentation span the start opened (_span_open)
        self.span = None
        # an abstract run's (analysis/): what the wait's event records,
        # the JAX package's first exchange piece
        self.piece = None

    def __repr__(self):
        state = "waited" if self.waited else "in-flight"
        return f"AsyncHandle({self.kind}#{self.uid}, mode={self.mode}, {state})"


class P2PHandle(AsyncHandle):
    """One async point-to-point half (``kind`` ``"send"`` or ``"recv"``),
    closed by ``p2p_wait``."""

    __slots__ = ("tag",)

    def __init__(self, kind, comm, tag):
        super().__init__(kind, comm, None)
        self.tag = tag

    def __repr__(self):
        state = "waited" if self.waited else "in-flight"
        return f"P2PHandle({self.kind}#{self.uid}, tag={self.tag}, {state})"


def _start(opname: str, comm, make):
    """The region's comm for ``comm`` and a new handle ``make(comm)``,
    registered with the region, whose end checks that it was waited."""
    ctx = current_context()
    if ctx is None:
        raise RuntimeError(
            f"{opname}: the async start/wait collectives work inside a "
            "region only (spmd / run), whose end waits for what is still "
            "in flight")
    comm = check_comm(comm, opname)
    handle = make(comm)
    handle.loop = ctx.megastep
    ctx.handles.append(handle)
    return comm, handle


def _check_span(opname: str, handle: AsyncHandle) -> None:
    """MPX130 where the wait is not in the megastep iteration of its
    start."""
    ctx = current_context()
    here = ctx.megastep if ctx is not None else None
    if handle.loop == here:
        return
    where = ("the start is in a megastep iteration and the wait outside it"
             if handle.loop is not None else
             "the wait is inside a megastep iteration but its start is not")
    raise mpx_error(
        RuntimeError, "MPX130",
        f"{opname}: async span {handle.kind}#{handle.uid} straddles a "
        f"megastep loop boundary: {where}; keep each *_start/*_wait pair "
        "inside one loop iteration, or drop unroll= for this program")


def close_iteration(ctx, scope, label: str, comm) -> None:
    """At the end of megastep iteration ``scope``: wait for every start it
    left in flight (its buffers are still being written), then raise
    MPX130 if there was one."""
    if ctx is None:
        return
    left = [h for h in ctx.handles
            if h.loop == scope and not h.waited and h.mode is not None]
    if not left:
        return
    ctx.handles = [h for h in ctx.handles if h not in left]
    for h in left:
        if h.mode == "async":
            _collect(h)
        _done(h, None)
    raise mpx_error(
        RuntimeError, "MPX130",
        f"megastep {label!r} on {comm!r}: iteration {scope[1]} ended with "
        f"{len(left)} start(s) in flight: "
        + ", ".join(f"{h.kind}#{h.uid}" for h in left)
        + "; an async span must open and close within one loop iteration")


# ---------------------------------------------------------------------------
# the instrumentation span (start -> wait)
# ---------------------------------------------------------------------------


def _span_open(base_op: str, comm, arrays, handle: AsyncHandle):
    """Open the pair's span at the start, inside the start's dispatch
    (``_base.OpSpan`` of the base op, its journal bracket under the
    start's telemetry record); returns the start's inputs (corrupted where
    a corrupt clause fired)."""
    from ..telemetry import core as _tcore
    from ._base import OpSpan, hooks

    h = hooks()
    span = None if h is None else OpSpan.open(h, base_op, comm, _tcore.current_open())
    if span is None:
        return arrays
    arrays = span.begin(arrays)
    handle.span = span
    return arrays


def _span_close(handle: AsyncHandle, results) -> None:
    """Close the span once the pair's result is ready."""
    span, handle.span = handle.span, None
    if span is not None:
        span.end()
        span.finish([r for r in results if isinstance(r, torch.Tensor)])


def _dispatch_start(opname: str, comm, body, arrays, token, handle, ana,
                    result=meta_like, piece=None):
    """A start through the dispatch point; a start that raises after its
    span opened disarms it (its wait will never come).  ``ana`` is its
    static structure for the verifier; in an abstract run the start
    returns a handle whose result is ``result(x)`` (a ``meta`` tensor)
    and whose wait records ``piece(x)`` (default the result)."""

    def abstract(arrays, token):
        (x,) = arrays
        handle.shape, handle.dtype, handle.device = x.shape, x.dtype, x.device
        res = result(x)
        handle.shape = res.shape
        handle.piece = res if piece is None else piece(x)
        _full(handle, res)
        return handle, produce(token)

    try:
        return run_body(opname, comm, body, arrays, token, bare=True, ana=ana,
                        abstract=abstract)
    except BaseException:
        span, handle.span = handle.span, None
        if span is not None:
            span.disarm()
        raise


def _dispatch_wait(opname: str, handle, body, token):
    """A wait through the dispatch point; an abstract run records the
    handle's piece and returns its ``meta`` result."""
    arrays = ()
    ana = {"span": handle.uid}
    if _analysis.recording():
        arrays = (handle.piece,)
        if isinstance(handle, P2PHandle):
            ana["tag"] = handle.tag
    return run_body(opname, handle.comm, body, arrays, token, bare=True,
                    ana=ana, abstract=lambda a, t: (
                        _done(handle, handle.pieces[0]), produce(t)))


def _meter_chunks(opname: str, comm, dtype, n_chunks: int) -> None:
    from ..telemetry import core as _tcore

    _tcore.meter(f"overlap.{opname}.c{comm.uid}."
                 f"{_tcore.dtype_name(dtype)}.chunks", n_chunks)


def _full(handle: AsyncHandle, result) -> None:
    handle.mode = "full"
    handle.pieces = (result,)


def _whole(x: torch.Tensor) -> bool:
    """Whether the start runs the synchronous op: autograd follows ``x``,
    or a ``torch.func`` transform wraps it (the pieces in flight are
    buffers of the physical tensor, which the wait could not hand back
    batched)."""
    return wants_grad(x) or transformed(x)


def _issue(handle: AsyncHandle, device, calls: int, issue) -> None:
    """Run ``issue(exchange)``, which returns the works and buffers in
    flight, timed as ``calls`` collectives; the handle keeps them."""
    ex = Exchange(device)
    ex.start()
    handle.pieces = issue(ex)
    ex.stop(calls)
    handle.mode = "async"
    handle.exchange = ex


def _collect(handle: AsyncHandle) -> list:
    """Wait for every piece and bring each received buffer back to the
    handle's device, in issue order."""
    ex = handle.exchange
    ex.start(sync=False)
    out = []
    for work, recv, _send in handle.pieces:
        work.wait()
        out.append(ex.result(recv, non_blocking=True))
    ex.stop(0)
    return out


# ---------------------------------------------------------------------------
# allreduce
# ---------------------------------------------------------------------------


def allreduce_start(x, op=None, *, comm: Optional[Comm] = None,
                    token: Optional[Token] = None):
    """Begin an async allreduce; returns ``(handle, token)``.  Finish it
    with ``allreduce_wait``."""
    from .allreduce import _DIST_OPS, reduce_all

    op = SUM if op is None else op
    combine_fn(op)
    comm, handle = _start("allreduce_start", comm,
                          lambda c: AsyncHandle("allreduce", c, op))

    def body(comm, arrays, token):
        (x,) = _span_open("allreduce", comm, arrays, handle)
        handle.shape, handle.dtype, handle.device = x.shape, x.dtype, x.device
        handle.k = len(comm.members())
        ring = None if handle.k == 1 or _whole(x) else _ring_split(x, op, comm)
        if ring is not None:
            _start_ring(handle, x, op, comm, *ring)
            return handle, produce(token)
        if (handle.k == 1 or op not in _DIST_OPS or x.dtype == torch.bool
                or _whole(x) or (comm.groups is not None and op is Op.PROD)):
            _full(handle, reduce_all(x, op, comm))
            return handle, produce(token)
        flat = x.detach().reshape(-1)
        handle.sizes = overlap_chunk_split(
            flat.numel(), config.overlap_chunks(flat.numel() * x.element_size()))
        _meter_chunks("allreduce", comm, x.dtype, len(handle.sizes))

        def issue(ex):
            pieces, off = [], 0
            for n in handle.sizes:
                seg = flat[off:off + n]
                off += n
                buf = ex.send(seg)
                if buf.data_ptr() == seg.data_ptr():  # all_reduce writes in place
                    buf = buf.clone()
                work = dist.all_reduce(buf, op=_DIST_OPS[op], group=comm.group(),
                                       async_op=True)
                pieces.append((work, buf, None))
            return pieces

        _issue(handle, x.device, len(handle.sizes), issue)
        return handle, produce(token)

    def piece(x):
        # the JAX package's first ring piece: a rank's block of the first
        # chunk
        k = len(comm.members())
        if k == 1:
            return meta_like(x)
        sizes = overlap_chunk_split(
            x.numel(), config.overlap_chunks(x.numel() * x.element_size()))
        return meta_like(x, (-(-sizes[0] // k),))

    return _dispatch_start("allreduce_start", comm, body,
                           (_fusion.materialize_value(x),), token, handle,
                           {"reduction": reduction_name(op), "span": handle.uid},
                           piece=piece)


def allreduce_wait(handle, *, token: Optional[Token] = None):
    """Finish an async allreduce: returns ``(result, token)`` with the
    input's shape."""
    _check_handle("allreduce_wait", handle, "allreduce")

    def body(comm, arrays, token):
        if handle.mode == "full":
            res = handle.pieces[0]
        elif handle.mode in ("ring", "hier"):
            _annotate_wait(handle.mode)
            res = _finish_ring(handle)
        else:
            parts = _collect(handle)
            res = (torch.cat(parts) if len(parts) > 1 else parts[0]).reshape(
                handle.shape)
        return _done(handle, res), produce(token)

    return _dispatch_wait("allreduce_wait", handle, body, token)


def _ring_split(x: torch.Tensor, op, comm):
    """``(mode, plan, k)`` where the start splits into the ring phases:
    ``"hier"`` where the selector takes the two-level lowering on a plan
    of several ranks a host, ``"ring"`` under a forced ring; ``None``
    otherwise (an ``Op`` reduction on a uniform group only).  Annotates
    the pick and its modeled bytes by link class."""
    from . import _algos, _hierarchy

    k = _algos.static_group_size(comm)
    algo = config.collective_algo()
    if k is None or k <= 1 or not isinstance(op, Op) or algo == "butterfly":
        return None
    plan = _hierarchy.hier_plan(comm)
    nbytes = x.numel() * x.element_size()
    if plan is not None and plan.r > 1 and _algos.resolve_algo(
            algo, nbytes, k, ring_ok=True, hier_ok=True) == "hier":
        mode = "hier"
        link = _hierarchy.hier_link_bytes("allreduce", nbytes, plan.h, plan.r)
    elif algo == "ring":
        mode, plan = "ring", None
        link = _hierarchy.flat_link_bytes("allreduce", "ring", nbytes, k,
                                          _hierarchy.comm_hosts(comm))
    else:
        return None
    _analysis.annotate(algo=mode)
    from ..telemetry import core as _tcore

    _tcore.annotate(algo=mode, link_bytes=link)
    return mode, plan, k


def _annotate_wait(algo: str) -> None:
    """A wait's annotation: its start's algorithm, and no bytes of its own
    (the start counted the exchange's model)."""
    from ..telemetry import core as _tcore

    _analysis.annotate(algo=algo)
    _tcore.annotate(algo=algo, link_bytes=(0, 0))


def _start_ring(handle: AsyncHandle, x, op, comm, mode, plan, k) -> None:
    """Each piece's reduce-scatter phase now (and, for ``hier``, the
    inter-host allreduce of its shard), the JAX package's chunked start."""
    from . import _algos, _hierarchy

    flat = x.detach().reshape(-1)
    nbytes = flat.numel() * x.element_size()
    handle.sizes = overlap_chunk_split(flat.numel(),
                                       config.overlap_chunks(nbytes))
    handle.mode, handle.plan, handle.k = mode, plan, k
    _meter_chunks("allreduce", comm, x.dtype, len(handle.sizes))
    pieces, off = [], 0
    for n in handle.sizes:
        seg = flat[off:off + n]
        off += n
        if mode == "hier":
            plan.ready()
            chunk, padded = _algos.chunk_layout(n, plan.r)
            blocks = _algos._pad_to(seg, padded).reshape(plan.r, chunk)
            piece = _algos.apply_ring_reduce_scatter(blocks, op, plan.intra,
                                                     plan.r)
            piece = _hierarchy._inter_allreduce(piece, op, plan,
                                                chunk * x.element_size())
        else:
            chunk, padded = _algos.chunk_layout(n, k)
            blocks = _algos._pad_to(seg, padded).reshape(k, chunk)
            piece = _algos.apply_ring_reduce_scatter(blocks, op, comm, k)
        pieces.append(piece)
    handle.pieces = tuple(pieces)


def _finish_ring(handle: AsyncHandle) -> torch.Tensor:
    """The wait of a ring split: each piece's ring allgather (over the
    plan's intra-host comm for ``hier``), reassembled."""
    from . import _algos

    if handle.mode == "hier":
        comm, k = handle.plan.intra, handle.plan.r
    else:
        comm, k = handle.comm, handle.k
    pos = comm.Get_rank()
    parts = [_algos.apply_ring_allgather(piece, comm, k, pos).reshape(-1)[:n]
             for piece, n in zip(handle.pieces, handle.sizes)]
    return (torch.cat(parts) if len(parts) > 1 else parts[0]).reshape(
        handle.shape)


# ---------------------------------------------------------------------------
# alltoall and reduce_scatter: blocks split along their payload
# ---------------------------------------------------------------------------


def _start_blocks(handle: AsyncHandle, x: torch.Tensor, comm: Comm) -> None:
    """Issue the alltoall of ``x``'s blocks in pieces along the payload."""
    from .alltoall import group_order

    size = handle.k
    blocks = x.detach().reshape(size, -1)
    handle.sizes = overlap_chunk_split(
        blocks.shape[1], config.overlap_chunks(x.numel() * x.element_size()))
    handle.order = group_order(comm)
    _meter_chunks(handle.kind, comm, x.dtype, len(handle.sizes))

    def issue(ex):
        pieces, off = [], 0
        for n in handle.sizes:
            seg = blocks[:, off:off + n]
            off += n
            if handle.order is not None:
                seg = seg[handle.order]
            send, recv = ex.send(seg), ex.buffer(seg)
            work = dist.all_to_all_single(recv, send, group=comm.group(),
                                          async_op=True)
            pieces.append((work, recv, send))
        return pieces

    _issue(handle, x.device, len(handle.sizes), issue)


def _received_rows(handle: AsyncHandle) -> torch.Tensor:
    """The received blocks ``(size, n)`` in comm-rank order."""
    from .alltoall import unpermute

    parts = [unpermute(p, handle.order) for p in _collect(handle)]
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def _check_blocks(opname: str, x, comm: Comm) -> int:
    size = comm.Get_size()
    if x.ndim == 0 or x.shape[0] != size:
        raise ValueError(
            f"{opname} input must have leading axis == comm size ({size}), "
            f"got shape {tuple(x.shape)}")
    return size


def alltoall_start(x, *, comm: Optional[Comm] = None,
                   token: Optional[Token] = None):
    """Begin an async alltoall of ``x`` (``(size, *s)``, block i to rank
    i); returns ``(handle, token)``.  Finish it with ``alltoall_wait``."""
    from .alltoall import _AllToAll, select_alltoall

    comm, handle = _start("alltoall_start", comm,
                          lambda c: AsyncHandle("alltoall", c, None))
    x = _fusion.materialize_value(x)
    handle.k = _check_blocks("alltoall_start", x, comm)

    def body(comm, arrays, token):
        (x,) = _span_open("alltoall", comm, arrays, handle)
        handle.shape, handle.dtype, handle.device = x.shape, x.dtype, x.device
        if handle.k == 1:
            _full(handle, x.clone())
        elif _whole(x):
            _full(handle, _AllToAll.apply(x, comm))
        else:
            algo, plan = select_alltoall(x, comm)
            if algo == "hier":
                _start_hier_alltoall(handle, x, comm, plan)
            else:
                _start_blocks(handle, x, comm)
        return handle, produce(token)

    def piece(x):
        # the JAX package's first exchange piece: every block's first chunk
        if handle.k == 1:
            return meta_like(x)
        blocks = x.reshape(handle.k, -1)
        sizes = overlap_chunk_split(
            blocks.shape[1], config.overlap_chunks(x.numel() * x.element_size()))
        return meta_like(x, (handle.k, sizes[0]))

    return _dispatch_start("alltoall_start", comm, body, (x,), token, handle,
                           {"span": handle.uid}, piece=piece)


def alltoall_wait(handle, *, token: Optional[Token] = None):
    """Finish an async alltoall: returns ``(result, token)``, ``out[i]``
    the block rank i addressed to this rank."""
    _check_handle("alltoall_wait", handle, "alltoall")

    def body(comm, arrays, token):
        if handle.mode == "full":
            res = handle.pieces[0]
        elif handle.mode == "hier":
            _annotate_wait("hier")
            res = torch.cat(handle.pieces, dim=1).reshape(handle.shape)
        else:
            res = _received_rows(handle).reshape(handle.shape)
        return _done(handle, res), produce(token)

    return _dispatch_wait("alltoall_wait", handle, body, token)


def _start_hier_alltoall(handle: AsyncHandle, x, comm, plan) -> None:
    """The hierarchical alltoall of each piece of every block, at the
    start (the JAX package's chunked hier split); the wait reassembles."""
    from ._hierarchy import apply_hier_alltoall

    size = handle.k
    blocks = x.detach().reshape(size, -1)
    handle.sizes = overlap_chunk_split(
        blocks.shape[1], config.overlap_chunks(x.numel() * x.element_size()))
    _meter_chunks("alltoall", comm, x.dtype, len(handle.sizes))
    pieces, off = [], 0
    for n in handle.sizes:
        pieces.append(apply_hier_alltoall(blocks[:, off:off + n], comm, plan))
        off += n
    handle.mode, handle.plan, handle.pieces = "hier", plan, tuple(pieces)


def reduce_scatter_start(x, op=None, *, comm: Optional[Comm] = None,
                         token: Optional[Token] = None):
    """Begin an async reduce_scatter of ``x`` (``(size, *s)``, block i to
    rank i); returns ``(handle, token)``.  Finish it with
    ``reduce_scatter_wait``."""
    from .reduce_scatter import scatter_reduced

    op = SUM if op is None else op
    combine_fn(op)
    comm, handle = _start("reduce_scatter_start", comm,
                          lambda c: AsyncHandle("reduce_scatter", c, op))
    x = _fusion.materialize_value(x)
    handle.k = _check_blocks("reduce_scatter_start", x, comm)

    def body(comm, arrays, token):
        (x,) = _span_open("reduce_scatter", comm, arrays, handle)
        handle.shape, handle.dtype, handle.device = x.shape[1:], x.dtype, x.device
        if handle.k == 1 or not isinstance(op, Op) or _whole(x):
            _full(handle, scatter_reduced(x, op, comm))
        else:
            _start_blocks(handle, x, comm)
        return handle, produce(token)

    return _dispatch_start("reduce_scatter_start", comm, body, (x,), token,
                           handle,
                           {"reduction": reduction_name(op), "span": handle.uid},
                           result=lambda x: meta_like(x, x.shape[1:]))


def reduce_scatter_wait(handle, *, token: Optional[Token] = None):
    """Finish an async reduce_scatter: returns ``(result, token)``, this
    rank's reduced block."""
    _check_handle("reduce_scatter_wait", handle, "reduce_scatter")

    def body(comm, arrays, token):
        if handle.mode == "full":
            res = handle.pieces[0]
        else:
            rows = _received_rows(handle)
            out = fold(rows.unbind(0), combine_fn(handle.reduction))
            res = out.to(torch.promote_types(out.dtype, handle.dtype)).reshape(
                handle.shape)
        return _done(handle, res), produce(token)

    return _dispatch_wait("reduce_scatter_wait", handle, body, token)


# ---------------------------------------------------------------------------
# point to point
# ---------------------------------------------------------------------------


def send_start(x, dest, tag: int = 0, *, comm: Optional[Comm] = None,
               token: Optional[Token] = None):
    """Begin an async send of ``x`` along ``dest``: queued for the matching
    ``recv_start`` or ``recv`` as ``send`` queues it (its message leaves at
    once, buffered).  Returns ``(handle, token)``; close it with
    ``p2p_wait``."""
    comm, handle = _start("send_start", comm, lambda c: P2PHandle("send", c, tag))

    def body(comm, arrays, token):
        (x,) = _span_open("send", comm, arrays, handle)
        send(x, dest, tag, comm=comm)
        handle.shape, handle.dtype, handle.device = x.shape, x.dtype, x.device
        _full(handle, x)
        return handle, produce(token)

    from .send import abstract_send
    from .sendrecv import _p2p_ana

    ana = dict(_p2p_ana(comm, None, dest, tag, "send_start"), span=handle.uid)
    if _analysis.recording():
        abstract_send(x, dest, tag, comm, ana["pairs"])
    return _dispatch_start("send_start", comm, body,
                           (_fusion.materialize_value(x),), token, handle, ana)


def recv_start(x, source=None, tag: int = 0, *, comm: Optional[Comm] = None,
               token: Optional[Token] = None):
    """Begin an async receive into ``x``'s shape and dtype from the
    matching queued send (``source=None`` adopts its routing, as
    ``recv``); returns ``(handle, token)``, the received tensor comes from
    ``p2p_wait``."""
    comm, handle = _start("recv_start", comm, lambda c: P2PHandle("recv", c, tag))

    def body(comm, arrays, token):
        (x,) = _span_open("recv", comm, arrays, handle)
        handle.shape, handle.dtype, handle.device = x.shape, x.dtype, x.device
        q = queue(comm, tag)
        if _whole(x) or (q and _whole(q[0].x)):
            _full(handle, recv(x, source, tag, comm=comm)[0])
            return handle, produce(token)
        pending = match(x, source, tag, comm, "recv_start")
        rank = comm.Get_rank()
        if pending.frm is None or pending.frm == rank:
            pending.release()
            got = (x.clone() if pending.frm is None
                   else pending.x.reshape(x.shape).clone())
            _full(handle, got)
            return handle, produce(token)

        def issue(ex):
            buf = ex.buffer(x)
            work = dist.irecv(buf, src=comm.global_rank(pending.frm),
                              tag=pending.wire)
            pending.release()
            return [(work, buf, None)]

        _issue(handle, x.device, 1, issue)
        return handle, produce(token)

    from .recv import abstract_match

    ana = {"span": handle.uid, "tag": tag}
    if _analysis.recording():
        ana.update(abstract_match(x, source, tag, comm, None, "recv_start"))
    return _dispatch_start("recv_start", comm, body,
                           (_fusion.materialize_value(x),), token, handle, ana)


def p2p_wait(handle, *, token: Optional[Token] = None):
    """Finish an async point-to-point half: returns ``(value, token)``,
    the received tensor for ``recv_start``'s handle and the sent payload
    for ``send_start``'s."""
    _check_p2p_handle("p2p_wait", handle)

    def body(comm, arrays, token):
        res = handle.pieces[0] if handle.mode == "full" else _collect(handle)[0]
        return _done(handle, res), produce(token)

    return _dispatch_wait("p2p_wait", handle, body, token)


def _done(handle: AsyncHandle, res):
    """Close the handle, and its span, once its result ``res`` is ready
    (``None`` where a region or iteration end collects it)."""
    handle.waited = True
    handle.pieces = handle.exchange = None
    _span_close(handle, [] if res is None else [res])
    return res


def _check_p2p_handle(opname: str, handle) -> None:
    if not isinstance(handle, P2PHandle):
        raise TypeError(f"{opname} expects the P2PHandle returned by "
                        f"send_start/recv_start, got {handle!r}")
    if handle.waited:
        raise mpx_error(
            RuntimeError, "MPX112",
            f"{opname}: this handle was already waited — each "
            "send_start/recv_start pairs with exactly one p2p_wait")
    _check_span(opname, handle)


def _check_handle(opname: str, handle, kind: str) -> None:
    if not isinstance(handle, AsyncHandle) or handle.kind != kind:
        raise TypeError(f"{opname} expects the AsyncHandle returned by "
                        f"{kind}_start, got {handle!r}")
    if handle.waited:
        raise mpx_error(
            RuntimeError, "MPX112",
            f"{opname}: this handle was already waited — each "
            f"{kind}_start pairs with exactly one {kind}_wait")
    _check_span(opname, handle)


def finish_region(ctx) -> None:
    """At a region's end: wait for every start it left in flight (its
    buffers are still being written), then raise MPX112 if there was
    one."""
    # a start that raised before it issued anything has no mode
    left = [h for h in ctx.handles if not h.waited and h.mode is not None]
    ctx.handles = []
    for h in left:
        if h.mode == "async":
            _collect(h)
        _done(h, None)
    if left:
        raise mpx_error(
            RuntimeError, "MPX112",
            f"region ended with {len(left)} start(s) never waited: "
            + ", ".join(f"{h.kind}#{h.uid}" for h in left)
            + "; each *_start pairs with exactly one *_wait")


# ---------------------------------------------------------------------------
# overlap(): implicit start/wait
# ---------------------------------------------------------------------------


_overlap_stack: List["overlap"] = []


class overlap:
    """``with overlap():`` splits every ``allreduce``, ``reduce_scatter``
    and ``alltoall`` inside it into its start, issued at the call, and its
    wait, deferred to the result's first use or the scope's end, so the
    compute between the two overlaps the exchange.  Needs a region."""

    def __enter__(self):
        if current_context() is None:
            raise RuntimeError(
                "overlap() requires a region (spmd / run); use explicit "
                "allreduce_start/allreduce_wait outside one")
        self._lazies: list = []
        _overlap_stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        _overlap_stack.pop()
        if exc_type is None:
            for lw in self._lazies:
                lw._force()
        return False


class _LazyWait(_fusion.LazyResult):
    """A deferred wait: the first use of the result runs ``*_wait``."""

    __slots__ = ("_handle",)

    def __init__(self, handle):
        super().__init__(handle.shape, handle.dtype, handle.device, None)
        self._handle = handle

    def _force(self):
        if self._value is None:
            wait = {"allreduce": allreduce_wait, "alltoall": alltoall_wait,
                    "reduce_scatter": reduce_scatter_wait}[self._handle.kind]
            self._value = wait(self._handle)[0]
        return self._value


def overlap_active() -> bool:
    """Inside ``overlap()`` and not inside a fusion flush."""
    return bool(_overlap_stack) and not _fusion._inhibit


def maybe_lazy(opname: str, x, op, comm, token):
    """Route one collective through its start and a deferred wait;
    ``None`` outside ``overlap()``."""
    if not overlap_active() or not _fusion.deferrable(
            _fusion.materialize_value(x), current_context().level):
        return None
    if opname == "allreduce":
        handle, tok = allreduce_start(x, op, comm=comm, token=token)
    elif opname == "alltoall":
        handle, tok = alltoall_start(x, comm=comm, token=token)
    else:
        handle, tok = reduce_scatter_start(x, op, comm=comm, token=token)
    lw = _LazyWait(handle)
    _overlap_stack[-1]._lazies.append(lw)
    return lw, tok
