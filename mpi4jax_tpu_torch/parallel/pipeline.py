"""Pipeline-parallel schedule compiler: GPipe, 1F1B, interleaved.

PyTorch counterpart of ``mpi4jax_tpu/parallel/pipeline.py``.  One stage
of a layered model per rank, microbatches wavefronting through the stage
chain:

- the pure half (no torch at import): :func:`rank_program` (each rank's
  forward/backward micro-op program for every schedule),
  :func:`stash_depth` (the activation stash a program holds: ``M`` for
  gpipe, ``min(S, M)`` for 1f1b), :func:`compile_phases` (the
  warmup/steady/cooldown tick split, a :class:`PhasePlan`) and
  :func:`split_microbatches`, each the JAX package's;
- :class:`PipelineProgram` / :func:`pipeline`, the runnable round.  The
  ``gpipe`` boundary is a blocking ``sendrecv``; ``1f1b`` and
  ``interleaved`` run it through ``send_start``/``recv_start``/
  ``p2p_wait`` (``ops/_async.py``): the recv's wait lands after the tick's
  fresh-microbatch gather and the send's after the stage compute.  The
  steady window (every tick's input and output in range) runs through
  ``megastep_loop`` (``parallel/megastep.py``), every start/wait pair
  inside its iteration, so MPX130 holds.

Called eagerly (``prog(mbs, params)``) the warmup, steady and cooldown
phases are three region calls (``spmd``), cached per (comm, plan), each
under a host bracket: with telemetry on, ``pipeline.stage`` and
``pipeline.bubble_wait`` rows in the per-op table and the
``pipeline.stage_us``, ``pipeline.bubble_wait_us`` and
``pipeline.rounds`` meters, from which ``telemetry.report()`` renders the
measured bubble fraction; the bracket synchronises the comm's device
before it reads its clock, only while telemetry is on.
``prog.trace(mbs, params)`` runs the round inside the current region.

The port keeps rank-local tensors: ``mbs`` is this rank's ``(M, mb,
...)`` (stage 0's rows are the real microbatches, the others' are
ignored) and the round returns this rank's ``(M, mb, ...)``; the last
rank's holds the model output (the JAX package's eager call takes and
returns the global ``(S, M, mb, ...)`` stack).  ``params`` is this rank's
stage parameters: with ``virtual=v > 1`` every leaf carries a leading
chunk axis, chunk ``c`` of rank ``r`` being virtual stage ``c * S + r``.

``schedule="auto"`` prices every expressible schedule with the cost
model (``analysis/costmodel.py:best_schedule``, the active model: a
cost-model file, the tuning layer's links, else the card's defaults), as
the JAX package does: a chunked program (``virtual >= 2``) can only run
``interleaved``, a flat one takes the cheaper of ``gpipe`` and ``1f1b``.
A round stamps its ``(schedule, stages, microbatches, virtual, payload
bytes)`` on its first boundary transfer's event (``mark_last_event``),
which the cost pass's MPX144 reads.  The tuned ``pipeline_microbatches``
and ``pipeline_virtual_stages`` knobs apply through ``utils/config.py``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

__all__ = [
    "PipelineProgram",
    "SCHEDULES",
    "PhasePlan",
    "compile_phases",
    "pipeline",
    "rank_program",
    "split_microbatches",
    "stash_depth",
]

# the expressible schedules; "auto" resolves to one of these
SCHEDULES = ("gpipe", "1f1b", "interleaved")


# ---------------------------------------------------------------------------
# the pure half: per-rank micro-op programs and the phase split
# ---------------------------------------------------------------------------


def _validate(schedule: str, stages: int, microbatches: int,
              virtual: int) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(
            f"pipeline: unknown schedule {schedule!r} "
            f"(expressible: {SCHEDULES}, plus 'auto')"
        )
    if stages < 1:
        raise ValueError(f"pipeline: stages must be >= 1, got {stages}")
    if microbatches < 1:
        raise ValueError(
            f"pipeline: n_microbatches must be >= 1, got {microbatches}")
    if virtual < 1:
        raise ValueError(f"pipeline: virtual must be >= 1, got {virtual}")
    if schedule == "interleaved" and virtual < 2:
        raise ValueError(
            "pipeline: the interleaved schedule needs virtual >= 2 "
            "stage-chunks per rank (virtual=1 is plain 1f1b)"
        )
    if schedule != "interleaved" and virtual != 1:
        raise ValueError(
            f"pipeline: virtual={virtual} only applies to the "
            "interleaved schedule"
        )


def rank_program(schedule: str, stages: int, microbatches: int, rank: int,
                 virtual: int = 1) -> Tuple[Tuple[str, int, int], ...]:
    """Rank ``rank``'s ordered micro-op program: ``("F"|"B", microbatch,
    chunk)`` triples, the schedule's training-shaped accounting (a round
    runs the forward wavefront)."""
    _validate(schedule, stages, microbatches, virtual)
    if not 0 <= rank < stages:
        raise ValueError(f"pipeline: rank {rank} out of range for "
                         f"{stages} stage(s)")
    s, m, v = stages, microbatches, virtual
    if schedule == "gpipe":
        # synchronous flush: every forward, then every backward
        return tuple([("F", i, 0) for i in range(m)]
                     + [("B", i, 0) for i in reversed(range(m))])
    # 1f1b / interleaved: forward items in wavefront completion order
    # (chunk c of this rank is virtual stage c*S + rank); warmup fills the
    # pipe below this rank's deepest chunk, then one forward, one
    # backward, then the backward drain
    items = sorted((i + c * s + rank, c, i)
                   for i in range(m) for c in range(v))
    fwd = [(i, c) for _t, c, i in items]
    warmup = min(m * v, (s - 1 - rank) + (v - 1) * s)
    prog = []
    done = 0
    for j, (i, c) in enumerate(fwd):
        prog.append(("F", i, c))
        if j >= warmup:
            prog.append(("B",) + fwd[done])
            done += 1
    while done < len(fwd):
        prog.append(("B",) + fwd[done])
        done += 1
    return tuple(prog)


def stash_depth(program: Sequence[Tuple[str, int, int]]) -> int:
    """Peak number of live activation stashes a micro-op program holds
    (each F pushes its input activation for the matching B)."""
    depth = peak = 0
    for op, _i, _c in program:
        if op == "F":
            depth += 1
            peak = max(peak, depth)
        elif op == "B":
            depth -= 1
            if depth < 0:
                raise ValueError("pipeline: program pops an activation "
                                 "it never stashed")
    return peak


@dataclass(frozen=True)
class PhasePlan:
    """One compiled schedule: the tick split a round executes and the
    per-rank stash accounting.

    A forward round is ``ticks = M + P - 1`` wavefront ticks over ``P = S
    * v`` virtual stages: ``warmup`` ticks fill the pipe, ``steady`` ticks
    are the full-pipe window ``[P-1, M-1]`` (megastep-eligible), and
    ``cooldown`` ticks drain.  ``max_stash`` is the worst rank's
    activation-stash bound: ``M`` for gpipe, ``min(S, M)`` for 1f1b.
    """

    schedule: str
    stages: int
    microbatches: int
    virtual: int
    warmup: int
    steady: int
    cooldown: int
    ticks: int
    max_stash: int
    stash_by_rank: Tuple[int, ...]


def compile_phases(schedule: str, stages: int, microbatches: int,
                   virtual: int = 1) -> PhasePlan:
    """Compile ``schedule`` over ``stages`` x ``microbatches`` (and
    ``virtual`` chunks per rank) into its :class:`PhasePlan`."""
    _validate(schedule, stages, microbatches, virtual)
    p = stages * virtual
    ticks = microbatches + p - 1
    steady = max(0, microbatches - (p - 1))
    warmup = p - 1
    cooldown = ticks - warmup - steady
    stash = tuple(
        stash_depth(rank_program(schedule, stages, microbatches, r, virtual))
        for r in range(stages)
    )
    return PhasePlan(schedule=schedule, stages=stages,
                     microbatches=microbatches, virtual=virtual,
                     warmup=warmup, steady=steady, cooldown=cooldown,
                     ticks=ticks, max_stash=max(stash),
                     stash_by_rank=stash)


def split_microbatches(x, n: Optional[int] = None):
    """Split a batch-leading array or tensor ``(B, ...)`` into ``(M, B/M,
    ...)`` microbatches: ``n`` explicit, else
    ``MPI4JAX_TPU_PIPELINE_MICROBATCHES``, else 1.  ``B`` must divide
    evenly."""
    from ..utils import config

    if n is None:
        n = config.pipeline_microbatches(payload_bytes=_nbytes_of(x)) or 1
    n = int(n)
    b = int(x.shape[0])
    if n < 1 or b % n:
        raise ValueError(
            f"pipeline: cannot split batch of {b} into {n} equal "
            "microbatch(es)"
        )
    return x.reshape((n, b // n) + tuple(x.shape[1:]))


def _nbytes_of(x) -> int:
    n = 1
    for d in x.shape:
        n *= int(d)
    return n * getattr(getattr(x, "dtype", None), "itemsize", 4)


# ---------------------------------------------------------------------------
# the runnable program
# ---------------------------------------------------------------------------


StageFns = Union[Callable, Sequence[Callable]]


class PipelineProgram:
    """A compiled pipeline round: call it eagerly (three phase-bracketed
    region calls) or ``trace`` it inside an existing region.  ``mbs`` is
    this rank's ``(M, mb, ...)``; the result is this rank's ``(M, mb,
    ...)``, the last rank's holding the model output."""

    def __init__(self, stage_fns: StageFns, n_microbatches: Optional[int],
                 schedule: str, virtual: Optional[int], comm,
                 megastep: bool):
        if callable(stage_fns):
            self._fns: Optional[Tuple[Callable, ...]] = None
            self._fn: Optional[Callable] = stage_fns
        else:
            fns = tuple(stage_fns)
            if not fns or not all(callable(f) for f in fns):
                raise TypeError(
                    "pipeline: stage_fns must be a callable or a "
                    "non-empty sequence of callables (one per virtual "
                    "stage-chunk)"
                )
            self._fns, self._fn = fns, None
            if virtual is not None and virtual != len(fns):
                raise ValueError(
                    f"pipeline: virtual={virtual} disagrees with "
                    f"{len(fns)} stage_fns"
                )
            virtual = len(fns)
        if schedule != "auto" and schedule not in SCHEDULES:
            raise ValueError(
                f"pipeline: unknown schedule {schedule!r} "
                f"(expressible: {SCHEDULES}, plus 'auto')"
            )
        if schedule in ("gpipe", "1f1b") and virtual is not None and \
                int(virtual) >= 2:
            raise ValueError(
                f"pipeline: schedule={schedule!r} cannot run a program "
                f"carrying {virtual} stage-chunks per rank — only the "
                "interleaved schedule applies per-chunk stage fns; "
                "compose the chunks into one stage fn per rank, or use "
                "schedule='interleaved' (or 'auto')"
            )
        self._requested = schedule
        self._n_microbatches = n_microbatches
        self._virtual = virtual
        self._comm = comm
        self._megastep = bool(megastep)
        self._progs: Dict[tuple, tuple] = {}

    # -- planning ----------------------------------------------------------

    def _resolve_virtual(self, schedule: str) -> int:
        from ..utils import config

        v = self._virtual
        if v is None:
            v = config.pipeline_virtual_stages() or 0
        if schedule == "interleaved":
            return max(2, int(v))
        if schedule == "auto":
            return max(1, int(v))
        return 1

    def _carries_chunks(self) -> bool:
        """Whether this program is built from ``v >= 2`` stage-chunks per
        rank: only the interleaved schedule can run it (gpipe and 1f1b
        apply one stage fn per rank and would drop chunks ``1..v-1``)."""
        if self._fns is not None and len(self._fns) >= 2:
            return True
        return self._virtual is not None and int(self._virtual) >= 2

    def plan(self, stages: int, microbatches: int, payload_bytes: int
             ) -> PhasePlan:
        """Resolve ``schedule='auto'`` through the cost model and compile
        the phase plan (pure: callable without a device)."""
        schedule = self._requested
        virtual = self._resolve_virtual(schedule)
        if schedule == "auto":
            from ..analysis import costmodel

            model = costmodel.load_model()
            # the roofline floor of a stage's compute: it streams its
            # boundary activation in and out (the JAX package's estimate)
            compute_us = model.compute_us(2 * payload_bytes)
            schedule, _times = costmodel.best_schedule(
                stages, microbatches, payload_bytes, compute_us, model,
                virtual=virtual)
        if schedule != "interleaved":
            if self._carries_chunks():
                raise ValueError(
                    f"pipeline: this program carries "
                    f"{self._virtual} stage-chunks per rank but "
                    f"resolved schedule {schedule!r}; only "
                    "'interleaved' can run chunked stage fns — "
                    "gpipe/1f1b would silently drop every chunk but "
                    "the first"
                )
            virtual = 1
        return compile_phases(schedule, stages, microbatches, virtual)

    def _check_microbatches(self, m: int) -> None:
        if self._n_microbatches is not None and int(self._n_microbatches) != m:
            raise ValueError(
                f"pipeline: n_microbatches={self._n_microbatches} but "
                f"the input carries {m} microbatch(es); split the batch "
                "with mpi4jax_tpu_torch.parallel.pipeline.split_microbatches"
            )

    # -- inside a region ---------------------------------------------------

    def trace(self, mbs, params, *, token=None):
        """Run one round inside the current region: returns ``(out,
        token)``, ``out`` this rank's ``(M, mb, ...)``."""
        import torch

        from .region import current_context

        ctx = current_context()
        if self._comm is None and ctx is None:
            raise RuntimeError(
                "PipelineProgram.trace runs inside a region (spmd / run); "
                "call the program itself to run a round eagerly")
        comm = self._comm if self._comm is not None else ctx.comm
        m = int(mbs.shape[0])
        self._check_microbatches(m)
        plan = self.plan(comm.Get_size(), m, _nbytes_of(mbs[0]))
        ticks = _Ticks(self, plan, comm, mbs, params)
        h = torch.zeros((plan.virtual,) + tuple(mbs.shape[1:]),
                        dtype=mbs.dtype, device=mbs.device)
        out = torch.zeros_like(mbs)
        h, out, token = ticks.run(0, plan.warmup, h, out, token,
                                  use_megastep=False)
        h, out, token = ticks.run(plan.warmup, plan.warmup + plan.steady,
                                  h, out, token, use_megastep=self._megastep)
        h, out, token = ticks.run(plan.warmup + plan.steady, plan.ticks,
                                  h, out, token, use_megastep=False)
        return out, token

    # -- the eager phases ---------------------------------------------------

    def __call__(self, mbs, params):
        """One eager round: warmup, steady and cooldown as three region
        calls under ``pipeline.{phase}`` host brackets."""
        import torch

        from .region import resolve_comm

        m = int(mbs.shape[0])
        self._check_microbatches(m)
        comm = resolve_comm(self._comm)
        nbytes = _nbytes_of(mbs[0])
        plan = self.plan(comm.Get_size(), m, nbytes)
        warm, steady, cool = self._phase_progs(comm, plan)
        h = torch.zeros((plan.virtual,) + tuple(mbs.shape[1:]),
                        dtype=mbs.dtype, device=mbs.device)
        out = torch.zeros_like(mbs)
        with _phase_bracket(comm, plan, "bubble_wait", nbytes):
            h, out = warm(mbs, h, out, params)
        if steady is not None:
            with _phase_bracket(comm, plan, "stage", nbytes):
                h, out = steady(mbs, h, out, params)
        with _phase_bracket(comm, plan, "bubble_wait", nbytes):
            h, out = cool(mbs, h, out, params)
        return out

    def _phase_progs(self, comm, plan: PhasePlan):
        from .region import spmd

        key = (comm.uid, plan)
        cached = self._progs.get(key)
        if cached is not None:
            return cached

        def phase_fn(lo, hi, use_megastep):
            def run(mbs, h, out, params):
                ticks = _Ticks(self, plan, comm, mbs, params)
                h2, out2, _ = ticks.run(lo, hi, h, out, None,
                                        use_megastep=use_megastep)
                return h2, out2

            return spmd(run, comm=comm, unroll=1)

        warm = phase_fn(0, plan.warmup, False)
        steady = None
        if plan.steady:
            steady = phase_fn(plan.warmup, plan.warmup + plan.steady,
                              self._megastep)
        cool = phase_fn(plan.warmup + plan.steady, plan.ticks, False)
        progs = (warm, steady, cool)
        self._progs[key] = progs
        return progs


class _Ticks:
    """The tick machinery of one round on this rank: drives any ``[lo,
    hi)`` window of the plan's ticks, one by one or as one megastep
    loop."""

    def __init__(self, prog: PipelineProgram, plan: PhasePlan, comm,
                 mbs, params):
        self.prog, self.plan, self.comm = prog, plan, comm
        self.mbs, self.params = mbs, params
        self.stamped = False

    def _mark(self):
        """Stamp the round's schedule on its first boundary event (the
        cost pass's MPX144 reads it)."""
        if self.stamped:
            return
        self.stamped = True
        from ..analysis.hook import mark_last_event

        m0 = self.mbs[0]
        plan = self.plan
        mark_last_event("pipeline", (
            plan.schedule, plan.stages, plan.microbatches, plan.virtual,
            m0.numel() * m0.element_size()))

    def _chunk_fn(self, c: int):
        prog, v = self.prog, self.plan.virtual
        if prog._fns is not None:
            return lambda x: prog._fns[c](x, self.params)
        if v == 1:
            return lambda x: prog._fn(x, self.params)
        from ..utils.tree import tree_map

        pc = tree_map(lambda leaf: leaf[c], self.params)
        return lambda x: prog._fn(x, pc)

    def _boundary_starts(self, h, tok):
        """Issue the tick's boundary transfer.  gpipe: the blocking
        ``sendrecv`` (the returned "handle" is the received stack).  1f1b
        and interleaved: open both spans and return without waiting; the
        recv's wait comes in :meth:`_boundary_recv`, after the tick's
        wire-independent work, and the send's in
        :meth:`_boundary_send_finish`, after the stage compute."""
        from ..ops._async import recv_start, send_start
        from ..ops.sendrecv import sendrecv
        from .rankspec import shift

        # interleaved boundaries form a ring (the last rank's chunk-c
        # output is rank 0's chunk-(c+1) input); a flat pipe stops at the
        # edge
        dest = shift(1, wrap=self.plan.virtual > 1)
        if self.plan.schedule == "gpipe":
            got, tok = sendrecv(h, h, dest=dest, comm=self.comm, token=tok)
            self._mark()
            return None, got, tok
        sh, tok = send_start(h, dest, comm=self.comm, token=tok)
        rh, tok = recv_start(h, comm=self.comm, token=tok)
        return sh, rh, tok

    def _boundary_recv(self, rh, tok):
        if self.plan.schedule == "gpipe":
            return rh, tok  # the blocking boundary already delivered
        from ..ops._async import p2p_wait

        got, tok = p2p_wait(rh, token=tok)
        self._mark()
        return got, tok

    def _boundary_send_finish(self, sh, tok):
        if sh is None:
            return tok
        from ..ops._async import p2p_wait

        _, tok = p2p_wait(sh, token=tok)
        return tok

    def _advance(self, got, feed):
        import torch

        v = self.plan.virtual
        # chunk c's input: the upstream stage's output, got[c] from rank
        # r-1; on rank 0 the ring delivers the last rank's chunk c-1, and
        # chunk 0 eats the fresh microbatch
        if self.comm.Get_rank() == 0:
            inp = torch.cat([feed[None], got[:-1]]) if v > 1 else feed[None]
        else:
            inp = got
        return torch.stack([self._chunk_fn(c)(inp[c]) for c in range(v)])

    def _tick(self, t: int, h, out, tok):
        import torch

        plan = self.plan
        p = plan.stages * plan.virtual
        sh, rh, tok = self._boundary_starts(h, tok)
        # inside the recv span: the fresh-microbatch gather never touches
        # the wire, so it overlaps the boundary transfer
        feed = (self.mbs[t] if t < plan.microbatches
                else torch.zeros_like(self.mbs[0]))
        got, tok = self._boundary_recv(rh, tok)
        h = self._advance(got, feed)
        tok = self._boundary_send_finish(sh, tok)
        if t >= p - 1:
            out[t - (p - 1)] = h[plan.virtual - 1]
        return h, out, tok

    def run(self, lo: int, hi: int, h, out, tok, *, use_megastep: bool):
        if hi <= lo:
            return h, out, tok
        if use_megastep and hi - lo > 1:
            from .megastep import megastep_loop

            def one(i, carry):
                hh, oo = carry
                hh, oo, _ = self._tick(i + lo, hh, oo, None)
                return hh, oo

            h, out = megastep_loop(one, (h, out), hi - lo, self.comm,
                                   label=f"pipeline[{self.plan.schedule}]")
            return h, out, tok
        for t in range(lo, hi):
            h, out, tok = self._tick(t, h, out, tok)
        return h, out, tok


def _phase_bracket(comm, plan: PhasePlan, phase: str, nbytes: int):
    """The host bracket around one phase call: a ``pipeline.{phase}`` row
    in the per-op table, a latency sample, and the integer-microsecond
    ``pipeline.{phase}_us`` meter (``pipeline.rounds`` for the steady
    phase).  With telemetry on, the comm's device is synchronised before
    the end timestamp, so that the bracket times the phase's work, not
    its launches; with it off, nothing is timed or synchronised."""
    from ..telemetry import core as tcore

    @contextlib.contextmanager
    def bracket():
        if tcore.effective_mode() == "off":
            yield
            return
        key = tcore.op_key(f"pipeline.{phase}", comm.uid, plan.schedule, "")
        t0 = time.perf_counter()
        try:
            yield
            _block_for_timing(comm)
        finally:
            dt = time.perf_counter() - t0
            tcore.count_host_op(key, nbytes)
            tcore.record_latency(key, dt)
            tcore.meter(f"pipeline.{phase}_us", max(0, int(dt * 1e6)))
            if phase == "stage":
                tcore.meter("pipeline.rounds")

    return bracket()


def _block_for_timing(comm) -> None:
    """Wait for the comm's device (a CUDA device; the CPU has nothing
    queued)."""
    import torch

    dev = comm.device
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def pipeline(stage_fns: StageFns, n_microbatches: Optional[int] = None,
             schedule: str = "auto", *, virtual: Optional[int] = None,
             comm=None, megastep: bool = True) -> PipelineProgram:
    """Compile a pipeline-parallel round over the comm's ranks (one stage
    per rank; ``virtual`` stage-chunks per rank under the interleaved
    schedule).

    ``stage_fns`` is one ``f(h, params)`` callable (with ``virtual=v > 1``
    every params leaf carries a leading chunk axis) or a sequence of
    per-chunk callables.  ``schedule`` is ``'auto'`` (priced by the cost
    model, see the module docstring), ``'gpipe'``, ``'1f1b'`` or ``'interleaved'``.
    A program carrying ``v >= 2`` stage-chunks per rank can only run the
    interleaved schedule: requesting gpipe or 1f1b raises.
    ``megastep=False`` runs the steady window tick by tick outside a
    megastep loop."""
    return PipelineProgram(stage_fns, n_microbatches, schedule, virtual,
                           comm, megastep)
