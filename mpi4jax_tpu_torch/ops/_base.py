"""Shared pieces of the ops: the reductions, MPX-tagged errors, buffer checks.

PyTorch counterpart of ``mpi4jax_tpu/ops/_base.py`` (``Op``, the local
combine of each reduction, ``combine_fn``) and of the
part of ``mpi4jax_tpu/analysis/report.py`` that the ops raise.  The codes
keep the JAX package's meaning, so a message greps the same:

- MPX101, unmatched send: a send still queued at ``flush()``;
- MPX102, recv without matching send: a recv found no queued send on its
  (comm, tag);
- MPX103, bare-int routing;
- MPX105, root out of range;
- MPX106, send/recv type-signature mismatch;
- MPX112, an async start waited twice, or never waited in its region;
- MPX126, a collective on a comm of a revoked elastic epoch
  (``check_comm``; ``resilience/elastic.py``);
- MPX127, a collective on a comm whose world drained past its leave
  boundary (``check_comm``);
- MPX129, a pinned program called after its world moved
  (``aot/invalidation.py``);
- MPX130, an async span that straddles a megastep loop boundary
  (``ops/_async.py``).

``fold`` combines the blocks of every rank in ascending group-rank order
with the association of the JAX package's doubling butterfly
(``apply_butterfly_allreduce``: after the round of offset ``w``, position
``p`` holds the fold of positions ``[p, p + 2w)``), so that a callable that
is associative but not commutative gives the same bits on every rank, and
the JAX package's bits.

``run_body`` is the dispatch point every op goes through (the JAX
package's ``_run_body``): the runtime services bracket each call there
(see its docstring).
"""

from __future__ import annotations

import enum
import itertools
from typing import Callable, Optional, Union

import torch

from ..parallel.region import current_context
from ..resilience import elastic as _elastic
from ..resilience import runtime as _resilience
from ..telemetry import bracket as _tbracket
from ..telemetry import core as _telemetry
from ..utils import config as _config
from ..utils import debug as _debug
from ..utils import profiling as _profiling
from ._fusion import flush_pending

CODES = frozenset({"MPX101", "MPX102", "MPX103", "MPX105", "MPX106", "MPX112",
                   "MPX126", "MPX127", "MPX129", "MPX130"})


class Op(enum.Enum):
    """Reduction operations, the members of the JAX package's ``Op``.  A
    Python callable ``f(a, b)`` is accepted wherever an ``Op`` is; it must
    be associative (MPI's contract), not commutative."""

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
LAND = Op.LAND
LOR = Op.LOR
LXOR = Op.LXOR
BAND = Op.BAND
BOR = Op.BOR
BXOR = Op.BXOR

OpLike = Union[Op, Callable]

# the local combine of each reduction: the logical ones give bool, the
# bitwise ones keep the input dtype (jnp.logical_* / jnp.bitwise_*)
_LOCAL_COMBINE = {
    Op.SUM: torch.add,
    Op.PROD: torch.mul,
    Op.MIN: torch.minimum,
    Op.MAX: torch.maximum,
    Op.LAND: torch.logical_and,
    Op.LOR: torch.logical_or,
    Op.LXOR: torch.logical_xor,
    Op.BAND: torch.bitwise_and,
    Op.BOR: torch.bitwise_or,
    Op.BXOR: torch.bitwise_xor,
}


def combine_fn(op: OpLike) -> Callable:
    """The binary function that combines two ranks' values under ``op``."""
    if isinstance(op, Op):
        return _LOCAL_COMBINE[op]
    if callable(op):
        return op
    raise TypeError(
        f"op must be an mpi4jax_tpu_torch.Op or a binary callable, got {op!r}"
    )


def fold(blocks, fn: Callable):
    """Combine ``blocks`` (a sequence in ascending group-rank order) with
    ``fn`` in the doubling butterfly's association; see the module
    docstring."""
    acc = list(blocks)
    k, w = len(acc), 1
    while w < k:
        acc = [fn(acc[p], acc[p + w]) if p + w < k else acc[p] for p in range(k)]
        w *= 2
    return acc[0]


def mpx_error(exc_type, code: str, message: str):
    """Build an exception tagged with a stable MPX code: the code rides
    along as ``exc.mpx_code`` and is appended to the message."""
    if code not in CODES:
        raise KeyError(f"unknown MPX code {code}")
    exc = exc_type(f"{message} [{code}]")
    exc.mpx_code = code
    return exc


def check_send_recv(sendbuf, recvbuf, what: str) -> None:
    """MPI's type-signature rule: equal dtypes, and shapes that differ only
    where the element counts match (the result takes ``recvbuf``'s shape)."""
    if sendbuf.dtype != recvbuf.dtype:
        raise mpx_error(
            ValueError, "MPX106",
            f"{what} requires matching send/recv dtypes (MPI type-signature "
            f"rule); got {sendbuf.dtype} vs {recvbuf.dtype}",
        )
    if sendbuf.shape != recvbuf.shape and sendbuf.numel() != recvbuf.numel():
        raise mpx_error(
            ValueError, "MPX106",
            f"{what}: send/recv buffers may differ in shape only when their "
            f"element counts match (the output is typed by recvbuf); got "
            f"{tuple(sendbuf.shape)} vs {tuple(recvbuf.shape)}",
        )


def check_root(root: int, size: int, what: str) -> None:
    """A static root must name a rank of the communicator (MPX105); on a
    color split, ``size`` is the smallest group's."""
    if isinstance(root, bool) or not isinstance(root, int):
        raise TypeError(f"{what}: root must be an int, got {type(root).__name__}")
    if not 0 <= root < size:
        raise mpx_error(
            ValueError, "MPX105",
            f"{what} root {root} out of range for size {size}",
        )


def check_comm(comm, what: str):
    """The comm an op runs on: ``comm``, or inside a region
    (``parallel/region.py``) the region's when ``comm`` is ``None``.
    Inside a region it first issues the fusion queue (``ops/_fusion.py``):
    an op that reaches here does not join it, and program order holds.
    A comm whose world executed a planned drain past its leave boundary
    raises MPX127, and a comm built in an epoch that an elastic boundary
    revoked raises MPX126: its ranks are a world that no longer exists
    (the JAX package's verifier flags both at trace time; the port has no
    trace).  MPX127 is checked first: a survivor's drained comm is also
    of a revoked epoch, and the drain is the specific cause."""
    ctx = current_context()
    if ctx is not None:
        flush_pending(ctx)
        if comm is None:
            comm = ctx.comm
    if comm is None:
        raise ValueError(f"{what}: pass comm= (no default communicator "
                         "outside a region: spmd, run)")
    if _elastic._drained_comms and _elastic.comm_drained(comm):
        raise mpx_error(
            RuntimeError, "MPX127",
            f"{what} on comm {comm.uid} was issued after the comm's leave "
            "boundary: its world executed a planned drain and the departed "
            "ranks will never enter this collective; use the comm "
            "elastic.run hands the step function after the drain boundary "
            "(it is rebuilt without the drained ranks; ShardStore.comm)",
        )
    if comm.epoch < _elastic.current_epoch():
        raise mpx_error(
            RuntimeError, "MPX126",
            f"{what} on {comm!r}, built in communication epoch {comm.epoch}, "
            f"which an elastic shrink revoked (the epoch is now "
            f"{_elastic.current_epoch()}): use the comm the recovery handed "
            "over (elastic.run's step receives it; ShardStore.comm), or a "
            "comm built since",
        )
    return comm


# ---------------------------------------------------------------------------
# the dispatch point
# ---------------------------------------------------------------------------


def mpi_opname(opname: str) -> str:
    return "MPI_" + opname.capitalize()


# call ids pair the begin/end hooks and the watchdog's arm/disarm of one
# call: unique per process, 8 hex characters as in the reference's lines
_call_id_counter = itertools.count()


def next_call_id() -> str:
    return f"{next(_call_id_counter) & 0xFFFFFFFF:08x}"


class Hooks:
    """Which runtime services are on, read once per configuration stamp:
    ``telemetry`` (counters or events), ``events``, ``tracing`` (native
    runtime trace), ``logging`` (the per-op debug line), ``resilience``
    (a watchdog timeout, a fault spec or numeric guards) and
    ``profiling`` (an open ``profile_ops`` capture, which names each op
    call's range; it runs nothing a pin must run eagerly for)."""

    __slots__ = ("telemetry", "events", "tracing", "logging", "resilience",
                 "profiling", "per_op")

    def __init__(self):
        mode = _telemetry.effective_mode()
        self.telemetry = mode != "off"
        self.events = mode == "events"
        self.tracing = _debug.get_runtime_tracing()
        self.logging = _debug.get_logging()
        self.profiling = _profiling.capture_open()
        timeout = _resilience.effective_watchdog_timeout()
        numerics = _resilience.effective_check_numerics()
        faults = bool(_resilience.effective_fault_clauses())
        self.resilience = timeout is not None or numerics or faults
        # the knob that makes every call run host code of its own, which a
        # CUDA-graph replay cannot run (aot/pinning.py), first one named
        per_op = (("MPI4JAX_TPU_TELEMETRY=events", self.events),
                  ("MPI4JAX_TPU_WATCHDOG_TIMEOUT", timeout is not None),
                  ("MPI4JAX_TPU_FAULT_SPEC", faults),
                  ("MPI4JAX_TPU_CHECK_NUMERICS", numerics),
                  ("MPI4JAX_TPU_TRACE", self.tracing),
                  ("MPI4JAX_TPU_DEBUG", self.logging))
        self.per_op = next((name for name, on in per_op if on), None)

    def any(self) -> bool:
        return (self.telemetry or self.tracing or self.logging
                or self.resilience or self.profiling)


_hooks_cell: list = [None, None]  # [service stamp, Hooks or None]


def hooks() -> Optional[Hooks]:
    """The services that are on, ``None`` when every one is off: one read
    of the services' stamp per call, the flags parsed only when it
    moved."""
    stamp = _config.service_stamp()
    if _hooks_cell[0] != stamp:
        h = Hooks()
        _hooks_cell[1] = h if h.any() else None
        _hooks_cell[0] = stamp
    return _hooks_cell[1]


def per_op_hook() -> Optional[str]:
    """The knob that asks for host code at every op call (the events tier,
    the watchdog, a fault spec, numeric guards, runtime tracing or debug
    logging), ``None`` when none does."""
    h = hooks()
    return None if h is None else h.per_op


# above 0 while an op's body runs instrumented: an op that runs inside
# another's body (scan's sendrecvs, scatter's alltoall) is part of that call
_depth = [0]


def run_body(opname: str, comm, body, arrays=(), token=None, bare=False):
    """Run op ``body(comm, arrays, token)`` bracketed by the runtime
    services every op shares, and return what it returns.  In the JAX
    package's order:

    - the fault probe, the input numeric guards and the watchdog arm
      (``resilience/runtime.py:Plan.before``; a corrupt clause replaces
      the inputs the body gets);
    - the events-tier journal begin (``telemetry/bracket.py``), after the
      probe, so that an injected delay shows as a late arrival;
    - the debug line and the native runtime trace's begin line
      (``native.py``);
    - the body;
    - the native trace's end line, the journal end, the watchdog disarm
      and the output guards; then the telemetry record is counted.

    On an exception the record is dropped (``abort_op``) and the watchdog
    disarmed.  ``bare=True`` keeps only the telemetry record: the async
    ``*_start``/``*_wait`` pairs open one span at the start and close it at
    the wait (``ops/_async.py``).  With every service off (the default)
    the body is called directly, after one read of the configuration
    stamp.  An op called inside another's body is part of that call.
    While a ``profile_ops`` capture is open, the call runs inside its
    ``mpi4jax_tpu.<op>`` range (``utils/profiling.py``).

    The end hooks run when the body has returned, and the body returns
    with its result ready: a multi-rank op on gloo stages its exchange
    through host memory and waits for it (``ops/_staging.py``).  A route
    with no message returns with its copy queued on the device.
    """
    h = hooks()
    if h is None or _depth[0]:
        return body(comm, arrays, token)
    _depth[0] += 1
    try:
        if h.profiling:
            with _profiling.op_range(opname):
                return _instrumented(h, opname, comm, body, arrays, token, bare)
        return _instrumented(h, opname, comm, body, arrays, token, bare)
    finally:
        _depth[0] -= 1


def _instrumented(h: Hooks, opname, comm, body, arrays, token, bare):
    rec = _telemetry.open_op(opname, comm, arrays) if h.telemetry else None
    span = None if bare else OpSpan.open(h, opname, comm, rec)
    if span is None and rec is None:
        return body(comm, arrays, token)
    try:
        if span is not None:
            arrays = span.begin(arrays)
        out = body(comm, arrays, token)
        # TODO(NCCL): a collective on NCCL returns before its result is
        # ready; its end hooks belong after a CUDA event recorded on the
        # op's stream once that event has completed (the event's query,
        # not a synchronisation of the whole device)
        if span is not None:
            span.end()
    except BaseException:
        _telemetry.abort_op(rec)
        if span is not None:
            span.disarm()
        raise
    if span is not None:
        span.finish(output_tensors(out))
    _telemetry.close_op(rec)
    return out


class OpSpan:
    """The per-call services around one op, or around an async pair from
    its start to its wait (``ops/_async.py``): the resilience plan, the
    events-tier journal bracket, the debug line and the native trace."""

    __slots__ = ("plan", "ebr", "tracing", "logging", "call_id", "name", "comm",
                 "rank", "armed")

    @classmethod
    def open(cls, h: Hooks, opname: str, comm, rec) -> Optional["OpSpan"]:
        """The span of one call of ``opname`` under the services ``h``
        (``rec``: its open telemetry record), ``None`` when none is on."""
        from .. import native

        plan = _resilience.plan_for(opname) if h.resilience else None
        ebr = _tbracket.bracket_for(rec)
        tracing = h.tracing and native.runtime_tracing_supported()
        if plan is None and ebr is None and not tracing and not h.logging:
            return None
        span = cls()
        span.plan, span.ebr, span.tracing, span.logging = plan, ebr, tracing, h.logging
        span.call_id, span.name = next_call_id(), mpi_opname(opname)
        span.comm, span.rank = comm, comm.global_rank(comm.Get_rank())
        span.armed = False
        return span

    def begin(self, arrays):
        """Before the op: probe, input guards, arm, journal begin, the
        begin lines; returns the inputs (corrupted where a clause fired)."""
        from .. import native

        if self.plan is not None:
            arrays = self.plan.before(self.name, self.call_id, self.comm,
                                      self.rank, arrays)
            self.armed = self.plan.timeout is not None
        if self.ebr is not None:
            self.ebr.begin(self.call_id, self.rank)
        if self.logging:
            native.host_line(self.comm.Get_rank(), f"{self.call_id} | {self.name}")
        if self.tracing:
            native.op_begin(self.name, self.call_id, self.comm.Get_rank(), "")
        return arrays

    def end(self) -> None:
        """The op's result is ready: the trace's end line, the journal end."""
        from .. import native

        if self.tracing:
            native.op_end(self.name, self.call_id, self.comm.Get_rank())
        if self.ebr is not None:
            self.ebr.end(self.call_id)

    def disarm(self) -> None:
        if self.armed:
            self.plan.disarm(self.call_id, self.rank)
            self.armed = False

    def finish(self, results) -> None:
        """After ``end``: the disarm and the output guards."""
        self.disarm()
        if self.plan is not None:
            self.plan.after(self.name, self.call_id, self.rank, results)


def output_tensors(out) -> list:
    """The tensors among an op's outputs (a result and a token, or a
    token)."""
    items = out if isinstance(out, tuple) else (out,)
    return [o for o in items if isinstance(o, torch.Tensor)]


# ---------------------------------------------------------------------------
# the public helpers of the JAX package's ops/_base.py
# ---------------------------------------------------------------------------


def varying(x, *, comm=None):
    """The JAX package's helper that re-types a replicated value as
    rank-varying, for carries of structured control flow that pass through
    a collective.  The port runs each rank's ops eagerly and has no
    replicated typing, so this is the identity, after the one thing the
    JAX package also does first: a deferred fusion or overlap result
    (``LazyResult``) anywhere in ``x`` is turned into its tensor, since
    re-typing is a use.  ``comm`` is accepted for the JAX package's
    signature; nothing here depends on it."""
    from ._fusion import materialize_tree

    return materialize_tree(x)


def cache_stats() -> dict:
    """Cache accounting, in the JAX package's keys:

    - ``hits``, ``misses``, ``evictions``, ``size``: what the port caches
      per op call.  The port compiles no program per call, so its eager
      tier is the resilience plan memo (``resilience/runtime.py:plan_for``,
      one ``Plan`` per op name and services' stamp): a hit is a call that
      found its plan, a miss one that built it, an eviction an entry
      dropped when the stamp moved, ``size`` the entries held.  The
      staging buffers of the multi-rank ops (``ops/_staging.py``) are no
      cache of the port's: each call takes its pinned host buffer from
      PyTorch's caching host allocator, which the port does not count;
    - ``"aot"``: the pin counters, ``"disk_cache"``: the persistent
      tier's counters and footprint (``aot.stats()``).

    ``clear_caches()`` resets them."""
    from .. import aot
    from ..resilience import runtime as _rt

    out = _rt.plan_memo_stats()
    out.update(aot.stats())
    return out


def clear_caches() -> None:
    """Empty the resilience plan memo (its counts too) and reset the pin,
    disk-tier and build counters; the tier's files stay on disk.  A pinned
    program keeps its graph: it is dropped with the object, as the JAX
    package's ``spmd`` programs are."""
    from .. import aot
    from ..resilience import runtime as _rt

    _rt.clear_plan_memo()
    aot.reset_stats()
