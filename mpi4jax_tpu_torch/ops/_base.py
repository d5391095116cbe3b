"""Shared pieces of the ops: the reductions, MPX-tagged errors, buffer checks.

PyTorch counterpart of ``mpi4jax_tpu/ops/_base.py`` (``Op``, the local
combine of each reduction, ``combine_fn``).  The MPX codes the ops raise
come from the one catalog of ``analysis/report.py`` (``mpx_error``), with
the JAX package's meaning, so a message greps the same:

- MPX101, unmatched send: a send still queued at ``flush()``;
- MPX102, recv without matching send: a recv found no queued send on its
  (comm, tag);
- MPX103, bare-int routing;
- MPX104, a root, tag or routing that is the rank of an abstract per-rank
  run (``analysis/schedule.py:RankConcrete``);
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
package's ``_run_body``): the runtime services bracket each call there,
and the collective verifier (``analysis/``) records there (see its
docstring).
"""

from __future__ import annotations

import enum
import itertools
from typing import Callable, Optional, Union

import torch
from torch._C import _functorch

from ..analysis import hook as _analysis
from ..analysis import lineage as _lineage
from ..analysis.report import mpx_error
from ..analysis.schedule import RankConcrete
from ..parallel.region import current_context
from ..resilience import elastic as _elastic
from ..resilience import runtime as _resilience
from ..telemetry import bracket as _tbracket
from ..telemetry import core as _telemetry
from ..utils import config as _config
from ..utils import debug as _debug
from ..utils import profiling as _profiling
from ..utils.transforms import batch_at, transformed  # noqa: F401  (the ops' names)
from ._fusion import flush_pending

# the codes the ops raise at dispatch, each an entry of the catalog
CODES = frozenset({"MPX101", "MPX102", "MPX103", "MPX104", "MPX105", "MPX106",
                   "MPX112", "MPX126", "MPX127", "MPX129", "MPX130"})


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


def annotate_native() -> None:
    """Record on the open verifier event and telemetry record that the op
    took its native route (the algorithm layer's ``"native"``)."""
    _analysis.annotate(algo="native")
    _telemetry.annotate(algo="native")


# ---------------------------------------------------------------------------
# torch.func: the batching rule of every exchange
# ---------------------------------------------------------------------------
#
# An op is Python around exchanges (``torch.distributed`` calls) and local
# arithmetic.  Under ``torch.func.vmap`` the arithmetic batches by itself
# and every check reads the lane's shape; an exchange runs once, on the
# physical tensor, as a batched JAX collective is one collective.  The
# exchanges sit inside ``Exchanged`` Functions: the differentiable ones of
# the ops (``_AllreduceSum``, ``_AllGather``, ``_SendRecv``, ...) and
# ``Lanes``, the thin one around an exchange with no rule of its own
# (``exchange``).  Their ``vmap`` rule lays the batch dim out as the
# exchange's family needs (``layout``) and applies the Function again, one
# level down, until ``forward`` gets plain tensors.  The grad and jvp
# levels unwrap in the same way (functorch's own rule for a Function), and
# a backward or jvp rule that runs an exchange goes through the same
# Functions, so ``jacrev`` (a vmap over a vjp) and ``jacfwd`` (a vmap over
# a jvp) batch too.


def wants_grad(x: torch.Tensor) -> bool:
    """Whether autograd follows ``x`` here: backward or forward
    (``torch.autograd.forward_ad``), or a ``torch.func`` grad or jvp level
    that tracks it, under any number of vmap levels."""
    if torch.is_grad_enabled() and x.requires_grad:
        return True
    if torch.autograd.forward_ad.unpack_dual(x).tangent is not None:
        return True
    while _functorch.is_functorch_wrapped_tensor(x):
        if _functorch.is_gradtrackingtensor(x):
            return True
        x = _functorch.get_unwrapped(x)
    return False


def _laid_out(at: int, out: int):
    def layout(size, in_dims, args):
        return [batch_at(size, d, a, at) if isinstance(a, torch.Tensor) else a
                for a, d in zip(args, in_dims)], out
    return layout


# the layouts, ``(batch size, in_dims, args) -> (args, out_dims)``, of the
# exchange families: elementwise (allreduce, bcast, reduce to root; the
# batch dim first), stacked (allgather: the size axis goes in front of the
# batch dim), blocks (alltoall: the lane's leading axis is the rank-block
# axis, so the batch dim goes behind it) and reduced blocks
# (reduce-scatter, whose result loses the block axis)
ELEMENTWISE = _laid_out(0, 0)
STACKED = _laid_out(0, 1)
BLOCKS = _laid_out(1, 1)
REDUCED_BLOCKS = _laid_out(1, 0)


class Exchanged(torch.autograd.Function):
    """A Function around an exchange, batched by its ``layout``: the vmap
    rule runs the Function once on the physical tensors."""

    layout: Callable = ELEMENTWISE

    @classmethod
    def vmap(cls, info, in_dims, *args):
        args, out_dims = cls.layout(info.batch_size, in_dims, args)
        return cls.apply(*args), out_dims


class Lanes(Exchanged):
    """``run(*tensors)``, an exchange with no Function of its own, on the
    physical tensors laid out by ``layout`` (see ``exchange``)."""

    @staticmethod
    def forward(run, layout, *tensors):
        return run(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @classmethod
    def vmap(cls, info, in_dims, run, layout, *tensors):
        tensors, out_dims = layout(info.batch_size, in_dims[2:], tensors)
        return cls.apply(run, layout, *tensors), out_dims


def exchange(run: Callable, layout: Callable, *tensors):
    """``run(*tensors)``; under a ``torch.func`` transform, once on the
    physical tensors (``Lanes``), the result re-wrapped as ``layout``
    says.  ``run`` must not be differentiated through: an op that autograd
    follows takes its Function."""
    if transformed(*tensors):
        return Lanes.apply(run, layout, *tensors)
    return run(*tensors)


class Substitute(Exchanged):
    """``value`` forward, with ``graph``'s backward: a lowering of the
    algorithm layer (``ops/_algos.py``, ``ops/_hierarchy.py``) changes an
    op's forward only; ``graph`` is the op's own differentiable route on
    the same inputs, whose backward rule stands."""

    @staticmethod
    def forward(graph, value):
        return value.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        return t


def lowered(x: torch.Tensor, run: Callable, graph: Callable) -> torch.Tensor:
    """``run(x)``, the forward of a lowering; where autograd follows ``x``,
    with the backward of ``graph(x)``, the op's own route."""
    if wants_grad(x):
        return Substitute.apply(graph(x), run(x.detach()))
    return run(x)


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


def reduction_name(op) -> str:
    """The name of a reduction in the verifier's event stream (the JAX
    package's ``reduction_name``)."""
    if isinstance(op, Op):
        return op.value
    return getattr(op, "__name__", "callable")


def refuse_rank_concrete(value, name: str, what: str) -> None:
    """MPX104: the rank of an abstract per-rank run is data, never a
    structural argument (a root, a tag): one program's structure serves
    every rank, and a per-rank run must refuse what the real run would."""
    if type(value) is RankConcrete:
        raise mpx_error(
            TypeError, "MPX104",
            f"{what}: argument {name!r} is the comm rank (concretized for "
            "per-rank analysis); structural arguments like roots, tags, and "
            "routing specs must be rank-uniform static Python values — one "
            "program's structure serves all ranks. Use a static value, or "
            "derive per-rank DATA from the rank instead.",
        )


def check_root(root: int, size: int, what: str) -> None:
    """A static root must name a rank of the communicator (MPX105); on a
    color split, ``size`` is the smallest group's."""
    refuse_rank_concrete(root, "root", what)
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
    call's range; it runs nothing a pin must run eagerly for); and the
    verifier's: ``collect`` (an abstract run records, ``analysis/hook.py``)
    and ``analyze`` (the ambient mode is ``warn`` or ``error``)."""

    __slots__ = ("telemetry", "events", "tracing", "logging", "resilience",
                 "profiling", "per_op", "collect", "analyze")

    def __init__(self):
        self.collect = _analysis.recording()
        self.analyze = _analysis.effective_mode() != "off"
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

    def services(self) -> bool:
        return (self.telemetry or self.tracing or self.logging
                or self.resilience or self.profiling)

    def any(self) -> bool:
        return self.services() or self.collect or self.analyze


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


def run_body(opname: str, comm, body, arrays=(), token=None, bare=False,
             ana=None, abstract=None):
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

    The verifier (``analysis/``): while an abstract run records, the op's
    event is recorded with ``ana``, its static structure (root, tag,
    routing pairs, reduction, span), and the body is not called:
    ``abstract(arrays, token)`` gives what the op returns, one rank's
    result as ``meta`` tensors (default: a tensor like ``arrays[0]`` and
    the token, or the token alone).  Under the ambient mode an op called
    outside every region is verified at its first call for each static
    key, before it runs (``analysis/crossrank.py:verify_eager``).

    The end hooks run when the body has returned, and the body returns
    with its result ready: a multi-rank op on gloo stages its exchange
    through host memory and waits for it (``ops/_staging.py``).  A route
    with no message returns with its copy queued on the device.
    """
    h = hooks()
    if h is None:
        return body(comm, arrays, token)
    if h.collect:
        return _record(opname, comm, arrays, token, ana, abstract)
    if _depth[0]:
        return body(comm, arrays, token)
    if h.analyze and current_context() is None:
        from ..analysis.crossrank import verify_eager

        verify_eager(opname, comm, arrays, token, ana)
    if not h.services():
        return body(comm, arrays, token)
    _depth[0] += 1
    try:
        if h.profiling:
            with _profiling.op_range(opname):
                return _instrumented(h, opname, comm, body, arrays, token, bare)
        return _instrumented(h, opname, comm, body, arrays, token, bare)
    finally:
        _depth[0] -= 1


def meta_like(t: torch.Tensor, shape=None) -> torch.Tensor:
    """An abstract result: a ``meta`` tensor of ``t``'s dtype and
    ``shape`` (default ``t``'s)."""
    return torch.empty(t.shape if shape is None else shape, dtype=t.dtype,
                       device="meta")


def _record(opname, comm, arrays, token, ana, abstract):
    """One op of an abstract run: its event, and its abstract output."""
    from .token import produce

    ctx = current_context()
    evt = _analysis.begin_event(opname, comm, arrays, token, ana, ctx,
                                eager=ctx is None)
    try:
        if abstract is not None:
            out = abstract(arrays, token)
        elif arrays:
            out = (meta_like(arrays[0]), produce(token))
        else:
            out = produce(token)
    except BaseException:
        if evt is not None:
            _analysis.abort_event(evt)
        raise
    if evt is not None:
        _analysis.end_event(evt, out)
    _lineage.op_eqn(opname, comm, arrays, ana, out)
    return out


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
    disk-tier and build counters; the tier's files stay on disk.  Drop the
    verifier's memo of ``analyze`` reports and of the keys the ambient
    mode verified.  A pinned program keeps its graph: it is dropped with
    the object, as the JAX package's ``spmd`` programs are."""
    from .. import aot
    from ..resilience import runtime as _rt

    _rt.clear_plan_memo()
    aot.reset_stats()
    _analysis.clear_analysis_caches()
