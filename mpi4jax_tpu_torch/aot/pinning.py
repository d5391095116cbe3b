"""Program pinning: ``compile`` and the ``PinnedProgram`` it returns.

PyTorch counterpart of ``mpi4jax_tpu/aot/pinning.py``.  There a pin is a
lowered and compiled XLA executable whose call does no per-call key work.
Here, on one CUDA rank, a pin is a captured CUDA graph: ``compile`` runs
the body once eagerly on a side stream (library loads, the allocator,
every first-use path such as a kernel's build or a divisor's
certification happen there), then captures it into a
``torch.cuda.CUDAGraph``, and every call replays the graph: one host call
launches everything the body launched.  A megastep pin
(``unroll=N``, ``parallel/megastep.py``) captures the N iterations into
one graph.  A failed capture raises; nothing falls back to the eager run.

On the CPU, and on a world of several ranks (whose exchanges are staged
through host memory on gloo, which a graph cannot hold), the program runs
the same region body eagerly at every call, with the same contracts:
that is the pin's documented meaning there, and ``program.graph`` says
which of the two a program is.  A body's own errors (the carry contract,
say) raise at ``compile`` where the warm-up runs it, and at the first
call where nothing runs before.

Results and donation.  A graph writes its outputs into the same buffers
at every replay, so a call returns copies that a later call does not
overwrite.  When ``donate_argnums`` covers every dynamic argument and the
output has the arguments' structure (a megastep's carry), the graph ends
with a copy of its output into its input buffers and a call returns those
buffers: the hot-loop idiom ``s = program(s)`` then copies nothing in or
out, and each call overwrites what the previous one returned.  A donation
that cannot alias (another structure, or only some arguments) copies as
without it.  ``bytes_copied`` counts the bytes a call copied.

Staleness (``aot/invalidation.py``): a call first compares the world it
was pinned in with the current one and raises ``StaleProgramError``
(MPX129) when a knob or an override moved; ``repin()`` captures anew.

Each replay adds the launches its graph holds to each kernel's count
(``kernels/_build.py:COUNTERS``), so a replayed kernel is counted as one
launched directly.

The runtime services (``telemetry/``, ``resilience/``, ``native.py``).
A replay runs no host code, so a graph cannot run the host hooks the
dispatch point puts around each op.  Under the ``counters`` tier alone a
pin keeps its graph: the capture stashes the telemetry records of the ops
its body ran (``telemetry/core.py:capture_eager``) and each replay counts
them, so a replayed op is counted as one called directly.  When a service
asks for host code at every op call (the ``events`` tier, the watchdog, a
fault spec, numeric guards, runtime tracing or debug logging), a pin on
one CUDA rank runs its body eagerly instead, the pin's meaning on the CPU
and on several ranks: ``program.graph`` is False, ``program.info`` names
the knob, and ``stats()["eager_pins"]`` and the meter ``aot.eager_pins``
count it.  Its kernels still run on the card.

``compile_step(fn, unroll=N)`` (``ElasticStep``) is the elastic loop's
adapter: a pin per world, stale when ``resilience/elastic.py:run`` hands
it the comm of a new epoch, re-pinned by the loop.

The persistent tier (``MPI4JAX_TPU_COMPILE_CACHE_DIR``,
``aot/diskcache.py``).  A CUDA graph cannot be serialized, so what a
second process can skip is the build of the kernel libraries
(``kernels/_build.py`` and ``native.py`` go through the tier themselves)
and the search for them.  A pin keeps a small record under its
``record_key`` (what it captured, without the donation, the same in every
process): the libraries its first run loaded.  At the pin, a found record
has those libraries loaded from the tier before the warm-up run
(``from_disk`` True when it was found and nothing was compiled); a missed
one is written after the capture (on the CPU and on several ranks, after
the first call, the first run).  ``through_disk_cache(fn, c, label)``
routes the first call of each argument signature through the same
record.  ``MPI4JAX_TPU_CPP_DISPATCH=false`` runs a pin on one CUDA rank
eagerly (``aot/fastpath.py``: the graph replay is the port's fast path).

The collective verifier (``analysis/``).  A replay runs no host code, so
under the ambient mode (``MPI4JAX_TPU_ANALYZE``) ``compile`` verifies the
program abstractly before its warm-up and capture, never inside the
graph; the mode is part of the pin's key, and flipping it stales the pin
(MPX129).  A call of a pin with ``donate_argnums`` records its donated
arguments for the MPX139/MPX140 checkers (``analysis/hook.py:
record_donation``), and inside an abstract run a pin runs its body on
the run's ``meta`` tensors.
"""

from __future__ import annotations

import types
from typing import Optional

import torch
import torch.distributed as dist

from ..analysis import hook as _analysis
from ..kernels import _build
from ..ops._base import hooks as _hooks
from ..ops._base import per_op_hook as _per_op_hook
from ..telemetry import core as _telemetry
from ..utils import config
from ..utils.tree import tree_flatten, tree_leaves
from . import diskcache, fastpath, keys, serialization
from .invalidation import WorldStamp

__all__ = ["PinnedProgram", "ElasticStep", "compile", "compile_step",
           "stats", "reset_stats", "through_disk_cache"]


class _Stats:
    __slots__ = ("pins", "calls", "stale_raises", "disk_loads", "compiles",
                 "fast_path_pins", "warmed", "replays", "copied_bytes",
                 "eager_pins")

    def __init__(self):
        self.reset()

    def reset(self):
        self.pins = 0
        self.calls = 0
        self.stale_raises = 0
        self.disk_loads = 0
        self.compiles = 0
        self.fast_path_pins = 0
        self.warmed = 0
        self.replays = 0
        self.copied_bytes = 0
        self.eager_pins = 0


_stats = _Stats()


def stats() -> dict:
    """Pinning counters: ``pins`` (programs pinned), ``calls`` (pinned
    calls), ``stale_raises`` (MPX129 refusals), ``disk_loads`` (pins and
    first calls served by a pin record of the persistent tier),
    ``compiles`` (those that were not), ``fast_path_pins`` (pins that
    replay a CUDA graph, ``aot/fastpath.py``), ``warmed`` (programs pinned
    by ``aot warm``), ``replays`` (CUDA-graph replays), ``copied_bytes``
    (bytes copied into and out of graphs by calls) and ``eager_pins``
    (pins on one CUDA rank that run eagerly under a per-op host hook or
    ``MPI4JAX_TPU_CPP_DISPATCH=false``; ``program.info`` names the
    knob)."""
    return {k: getattr(_stats, k) for k in _Stats.__slots__}


def reset_stats() -> None:
    _stats.reset()


def _signature(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor)
                 else (type(t).__name__,) for t in leaves)


def _check_signature(name: str, want, leaves) -> None:
    got = _signature(leaves)
    if got != want:
        raise ValueError(
            f"pinned program {name!r} was pinned for arguments {want} and "
            f"called with {got}: a pin accepts exactly the signature of the "
            "example arguments given to compile")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _one_rank_world() -> bool:
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)


class GraphRun:
    """A body captured as one CUDA graph.  ``__call__(*dyn)`` copies the
    arguments into the graph's input buffers (those that are not already
    them), replays, adds each kernel's captured launches to its count and
    returns the outputs (see the module docstring for donation)."""

    def __init__(self, body, dyn: tuple, name: str, alias: bool, pool=None):
        leaves, unflatten = tree_flatten(tuple(dyn))
        for t in leaves:
            if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
                raise TypeError(
                    f"compile({name!r}): a CUDA graph takes CUDA tensors as its "
                    f"dynamic arguments, got {type(t).__name__}"
                    + (f" on {t.device}" if isinstance(t, torch.Tensor) else ""))
        self.name = name
        self.signature = _signature(leaves)
        self.static_in = [t.detach().clone() for t in leaves]
        self.bytes_copied = 0
        device = leaves[0].device
        args = unflatten(self.static_in)
        # one eager run on a side stream first: every first-use path (a
        # kernel's build, a divisor's certification, the allocator) runs
        # here, since a capture allows no host synchronisation
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            body(*args)
        side.synchronize()
        current.wait_stream(side)

        before = {k: c.captured for k, c in _build.COUNTERS.items()}
        self.graph = torch.cuda.CUDAGraph()
        # the telemetry records of the ops the capture runs, counted at
        # every replay (nothing is recorded with telemetry off)
        self.telemetry = _telemetry.EagerCell()
        try:
            with torch.cuda.graph(self.graph, pool=pool), \
                    _telemetry.capture_eager(self.telemetry, ()):
                out = body(*args)
                out_leaves, self.unflatten_out = tree_flatten(out)
                self.alias = alias and _signature(out_leaves) == self.signature
                if self.alias:
                    # the carry goes back into the input buffers in the graph
                    for s, o in zip(self.static_in, out_leaves):
                        s.copy_(o)
        except Exception as e:
            raise RuntimeError(
                f"compile({name!r}): capturing the body as a CUDA graph failed "
                f"({type(e).__name__}: {e}); a pin on one CUDA rank is a CUDA "
                "graph, so everything the body runs must be capturable (no host "
                "synchronisation, no host-staged exchange)") from e
        finally:
            self.per_replay = {}
            for k, c in _build.COUNTERS.items():
                self.per_replay[k] = c.captured - before.get(k, 0)
                c.captured = before.get(k, 0)
        self.static_out = self.static_in if self.alias else [
            o for o in out_leaves]

    def __call__(self, *dyn):
        leaves = tree_leaves(tuple(dyn))
        _check_signature(self.name, self.signature, leaves)
        copied = 0
        for s, a in zip(self.static_in, leaves):
            if a is not s:
                s.copy_(a)
                copied += _nbytes(s)
        self.graph.replay()
        for k, n in self.per_replay.items():
            _build.COUNTERS[k].launches += n
        if self.telemetry.by_sig:
            # a capture under off stashed nothing, and a pin is captured
            # again when the tier changes: under off a replay counts nothing
            _telemetry.count_eager_call(self.telemetry, ())
        _stats.replays += 1
        if self.alias:
            outs = self.static_out
        else:
            outs = [o.clone() for o in self.static_out]
            copied += sum(_nbytes(o) for o in outs)
        self.bytes_copied = copied
        _stats.copied_bytes += copied
        return self.unflatten_out(outs)


class EagerRun:
    """The body run at every call: the pin's meaning on the CPU and on a
    world of several ranks, and on one CUDA rank under a per-op host hook
    (``reason``, the knob)."""

    def __init__(self, body, dyn: tuple, name: str, reason: Optional[str] = None,
                 record: Optional["_Record"] = None):
        self.body = body
        self.name = name
        self.signature = _signature(tree_leaves(tuple(dyn)))
        self.bytes_copied = 0
        self.reason = reason
        # written after the first call, the eager pin's first run
        self.record = record

    def __call__(self, *dyn):
        _check_signature(self.name, self.signature, tree_leaves(tuple(dyn)))
        record = self.record
        if record is None:
            return self.body(*dyn)
        self.record = None
        before = _build.launch_totals()
        out = self.body(*dyn)
        record.finish(before)
        return out


class PinnedProgram:
    """A pinned program: ``program(*dynamic_args)`` checks the captured
    world (one epoch compare, one compare of the raw variables) and
    replays the graph, or runs the body on the CPU or several ranks.
    Statics were folded at pin time: call with the dynamic arguments only,
    shaped as the examples given to ``compile``.  ``unroll`` is the
    megastep trip count (1: one step a call); ``graph`` says whether calls
    replay a CUDA graph; ``bytes_copied`` is what the last call copied;
    ``from_disk`` whether the pin's record was found in the persistent tier
    and nothing was compiled; ``fast_path`` whether calls take the graph
    replay (``aot/fastpath.py``)."""

    __slots__ = ("_run", "_world", "_respec", "fn_name", "key",
                 "donate_argnums", "unroll", "from_disk", "fast_path",
                 "_body", "_donate_call")

    def __init__(self, run, world: WorldStamp, respec, fn_name: str, key,
                 donate_argnums, unroll: int, from_disk: bool = False,
                 fast_path: bool = False, body=None, donate_call=()):
        self._run = run
        # the body itself, which an abstract run calls on its meta
        # tensors, and the donated positions among the call's arguments
        self._body = body
        self._donate_call = tuple(donate_call)
        self._world = world
        self._respec = respec
        self.fn_name = fn_name
        self.key = key
        self.donate_argnums = donate_argnums
        self.unroll = unroll
        self.from_disk = from_disk
        self.fast_path = fast_path

    @property
    def graph(self) -> bool:
        return isinstance(self._run, GraphRun)

    @property
    def bytes_copied(self) -> int:
        return self._run.bytes_copied

    @property
    def info(self) -> dict:
        """``graph`` and, for a pin on one CUDA rank that runs eagerly,
        ``eager_reason``: the knob that asked for a host hook at every op
        (``None`` otherwise)."""
        return {"graph": self.graph,
                "eager_reason": getattr(self._run, "reason", None)}

    def __call__(self, *args):
        world = self._world
        if not world.is_current():
            _stats.stale_raises += 1
            world.check(f"pinned program {self.fn_name!r}")
        _stats.calls += 1
        if self._donate_call:
            h = _hooks()
            if h is not None and (h.collect or h.analyze):
                donated = [args[i] for i in self._donate_call if i < len(args)]
                _analysis.record_donation(donated,
                                          f"pinned call {self.fn_name!r}")
        if _analysis.recording():
            return self._body(*args)
        return self._run(*args)

    def is_stale(self) -> bool:
        """Would the next call raise MPX129?"""
        return not self._world.is_current()

    def repin(self) -> "PinnedProgram":
        """Pin again against the current world: the way back after a
        ``StaleProgramError``."""
        return self._respec()

    def __repr__(self):
        return (f"PinnedProgram({self.fn_name!r}, "
                f"{'graph' if self.graph else 'eager'}, epoch={self._world.epoch}"
                + (f", unroll={self.unroll}" if self.unroll > 1 else "")
                + (", disk" if self.from_disk else "")
                + (", STALE" if self.is_stale() else "") + ")")


def _keyable(value):
    """A static value as a key part: itself where it canonicalizes, else
    its qualified name (a function, say, whose ``repr`` holds an
    address)."""
    try:
        keys.canonical(value)
        return value
    except TypeError:
        kind = value if callable(value) else type(value)
        return f"{kind.__module__}.{kind.__qualname__}"


def _code_text(code) -> bytes:
    """A code object's bytecode, names and constants (nested code
    recursed), without its file name or line numbers."""
    parts = [code.co_code, keys.canonical(code.co_names).encode(),
             keys.canonical(code.co_varnames).encode()]
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            parts.append(_code_text(c))
        else:
            try:
                parts.append(keys.canonical(c).encode())
            except TypeError:
                parts.append(type(c).__name__.encode())
    return b"|".join(parts)


def _where(name: str, fn) -> str:
    """The function as a key part: its qualified name and the fingerprint
    of its code, so that an edited body does not read a stale record."""
    where = f"{getattr(fn, '__module__', '')}.{getattr(fn, '__qualname__', name)}"
    code = getattr(fn, "__code__", None)
    if isinstance(code, types.CodeType):
        where += ":" + keys.fingerprint(_code_text(code))
    return where


def comm_descriptor(comm):
    """The comm as a key part, the same in every process: its kind, axes
    and split groups, its grid's shape, axes, rank and device, and the
    process group's backend (never its uid, which counts the comms a
    process built)."""
    if comm is None:
        return None
    grid = comm.mesh
    backend = (dist.get_backend() if dist.is_available() and dist.is_initialized()
               else "local")
    return (type(comm).__name__, tuple(comm.axes), comm.groups,
            None if grid is None else (tuple(grid.shape), tuple(grid.axes),
                                       grid.rank, str(grid.device)),
            backend)


def _key(name: str, fn, dyn_leaves, static_vals, comm, unroll: int,
         *extra) -> str:
    static_vals = tuple(_keyable(v) for v in static_vals)
    sig = tuple((tuple(t.shape), str(t.dtype), str(t.device))
                if isinstance(t, torch.Tensor) else (type(t).__name__,)
                for t in dyn_leaves)
    return keys.derive_key(keys.fingerprint(_where(name, fn)),
                           comm_descriptor(comm),
                           (sig, static_vals, unroll) + extra,
                           (torch.__version__, torch.version.cuda))


def record_key(name: str, fn, dyn_leaves, static_vals, comm, unroll: int) -> str:
    """The key of a pin's record in the persistent tier: the function, the
    dynamic arguments' shapes, dtypes and devices, the static values, the
    comm's shape and the unroll.  The donation is left out: it changes how
    a graph hands its buffers back, not the libraries it loads."""
    return _key(name, fn, dyn_leaves, static_vals, comm, unroll)


def program_key(name: str, fn, dyn_leaves, static_vals, comm, unroll: int,
                donate) -> str:
    """What a pin captured, as one key: ``record_key``'s parts, the
    donation, the verifier's mode (``analysis_cache_token``) and the
    algorithm layer's configuration (``ops/_algos.py:algo_cache_token``):
    a pin verified under one mode, or lowered under one algorithm, is not
    the pin of another."""
    from ..ops._algos import algo_cache_token

    return _key(name, fn, dyn_leaves, static_vals, comm, unroll, tuple(donate),
                _analysis.analysis_cache_token(), algo_cache_token())


def _compiles() -> int:
    from .. import native

    return _build.stats()["compiles"] + native.stats()["compiles"]


class _Record:
    """One pin record, keyed by ``record_key(*parts)``: looked up when made
    (the libraries it names are then loaded from the tier), written by
    ``finish`` after the first run when it was missed.  With the tier off
    it derives no key, does nothing and ``from_disk`` is False."""

    def __init__(self, fn_name: str, *parts):
        self.key = record_key(fn_name, *parts) if diskcache.enabled() else None
        self.fn_name = fn_name
        self.found = False
        self.loaded = True
        self.compiles = _compiles()
        if self.key is None:
            return
        # a record this schema cannot read is deleted and counts as a miss
        data = diskcache.get(self.key, use=lambda d: serialization.loads_record(
            d) is not None)
        if data is None:
            return
        rec = serialization.loads_record(data)
        self.found = True
        for lib in rec["libraries"]:
            out = _build.BUILD_DIR / lib["name"]
            if not out.exists() and not _build.from_tier(lib["key"], out):
                self.loaded = False

    def finish(self, before: dict) -> None:
        """After the first run (``before``: ``_build.launch_totals()``
        taken before it): write the record if it was missed."""
        if self.key is None or self.found:
            return
        payload = serialization.dumps_record(self.fn_name,
                                             _build.libraries_of(before))
        if payload is not None:
            diskcache.put(self.key, payload)

    @property
    def from_disk(self) -> bool:
        return self.found and self.loaded and _compiles() == self.compiles

    def count(self) -> bool:
        """Count the pin as loaded or compiled; returns ``from_disk``."""
        hit = self.from_disk
        if hit:
            _stats.disk_loads += 1
        else:
            _stats.compiles += 1
        return hit


def through_disk_cache(fn, c, label: str = "fn"):
    """Route ``fn`` through the persistent tier: once per argument
    signature the first call looks up its record (loading the libraries
    it names) and, on a miss, writes it after the run; every other call,
    and every call with the tier off, calls ``fn`` directly.  ``c`` is the
    comm the program runs over (a key part)."""
    seen = set()

    def cached_call(*args):
        if not diskcache.enabled():
            return fn(*args)
        leaves = tree_leaves(args)
        sig = _signature(leaves)
        if sig in seen:
            return fn(*args)
        seen.add(sig)
        record = _Record(label, fn, leaves, (), c, 1)
        before = _build.launch_totals()
        out = fn(*args)
        record.finish(before)
        record.count()
        return out

    return cached_call


def compile(fn, *example_args, comm=None, donate_argnums=(),
            static_argnums=None, wrap: Optional[bool] = None,
            unroll: Optional[int] = None, pool=None) -> PinnedProgram:
    """Pin ``fn(*example_args)``.

    ``fn`` follows the JAX package's three conventions:

    - an ``spmd``-decorated function: pinned as it is (its comm,
      static_argnums and unroll are adopted; pass overrides to replace
      them);
    - a plain per-rank function: run as a region over ``comm`` (or the
      default comm), the body ``spmd`` runs;
    - ``wrap=False``: run exactly as given, outside a region.

    ``example_args`` are tensors shaped as the call's (on one CUDA rank
    the capture's warm-up runs on copies of them).  Arguments named by
    ``static_argnums`` are folded into the program and not passed at
    call time.  ``donate_argnums`` indexes the original positions (see
    the module docstring).  ``unroll=N`` pins a megastep of N iterations
    (the region convention only); ``None`` takes
    ``MPI4JAX_TPU_UNROLL_DEFAULT``.  ``pool``: a
    ``torch.cuda.graph_pool_handle()`` whose memory the graph shares with
    other graphs replayed one at a time (the port's addition).
    """
    from ..parallel.megastep import validate_unroll
    from ..parallel.region import (
        normalize_statics,
        region_body,
        resolve_comm,
        resolve_unroll,
    )

    spec = dict(comm=comm, donate_argnums=donate_argnums,
                static_argnums=static_argnums, wrap=wrap, unroll=unroll,
                pool=pool)
    inner = fn
    if wrap is None:
        wrap = True
    if wrap and getattr(fn, "_mpx_spmd", False):
        crumbs = fn._mpx_spmd_kwargs
        inner = fn._mpx_fn
        if comm is None:
            comm = crumbs.get("comm")
        if static_argnums is None:
            static_argnums = crumbs.get("static_argnums")
        if unroll is None:
            unroll = crumbs.get("unroll")
    name = getattr(inner, "__name__", "fn")

    donate = normalize_statics(donate_argnums, len(example_args))
    statics = normalize_statics(static_argnums, len(example_args))
    overlap_ = set(donate) & set(statics)
    if overlap_:
        raise ValueError(
            f"cannot donate static argument(s) {sorted(overlap_)}: statics "
            "are folded into the program and never buffered"
        )
    static_vals = tuple(example_args[i] for i in statics)
    try:
        hash(static_vals)
    except TypeError as e:
        raise TypeError(
            "compile static argument values must be hashable (like jax.jit "
            f"static_argnums); got {static_vals!r}"
        ) from e
    dyn = tuple(a for i, a in enumerate(example_args) if i not in statics)

    if wrap is False:
        n_unroll = validate_unroll(unroll) if unroll is not None else 1
        if n_unroll > 1:
            raise ValueError(
                "compile(unroll=N) needs the region calling convention (a "
                "per-rank or spmd-decorated function): an eager-style "
                "wrap=False function has no per-rank carry to thread through "
                "the megastep loop"
            )
        c = comm

        def body(*d):
            full = list(d)
            for i, v in zip(statics, static_vals):
                full.insert(i, v)
            return fn(*full)
    else:
        c = resolve_comm(comm)
        n_unroll = resolve_unroll(unroll, len(dyn), what="compile")
        body = region_body(inner, c, statics, static_vals, n_unroll)

    # verified before the warm-up and the capture: a replay runs no host
    # code, and the region body's own check then finds its key verified
    if wrap is not False and _analysis.effective_mode() != "off" \
            and not _analysis.recording():
        from ..analysis.crossrank import verify_region

        _analysis._pinning[0] += 1
        try:
            verify_region(inner, c, statics, static_vals, n_unroll, dyn, {},
                          body)
        finally:
            _analysis._pinning[0] -= 1
    # captured before the warm-up: a knob moved during the pin leaves a
    # stamp that refuses the first call
    world = WorldStamp.capture()
    leaves = tree_leaves(dyn)
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    device = tensors[0].device if tensors else (c.device if c is not None else None)
    on_card = device is not None and device.type == "cuda" and _one_rank_world()
    per_op = _per_op_hook() if on_card else None
    if on_card and per_op is None and not config.cpp_dispatch():
        per_op = "MPI4JAX_TPU_CPP_DISPATCH"
    # the libraries a record names are loaded before the warm-up runs
    record = _Record(name, inner, leaves, static_vals, c, n_unroll)
    if on_card and per_op is None:
        alias = bool(dyn) and set(donate) == set(
            i for i in range(len(example_args)) if i not in statics)
        before = _build.launch_totals()
        run = GraphRun(body, dyn, name, alias, pool)
        record.finish(before)
    else:
        run = EagerRun(body, dyn, name, per_op, record)
        if per_op is not None:
            _stats.eager_pins += 1
            _telemetry.meter("aot.eager_pins")
    run, fast = fastpath.cpp_call_for(run)
    from_disk = record.count()
    _stats.pins += 1
    if fast:
        _stats.fast_path_pins += 1
    key = program_key(name, inner, leaves, static_vals, c, n_unroll, donate)
    dyn_pos = [i for i in range(len(example_args)) if i not in statics]

    def respec():
        return compile(fn, *example_args, **spec)

    return PinnedProgram(run, world, respec, name, key, donate, n_unroll,
                         from_disk, fast, body=body,
                         donate_call=[dyn_pos.index(i) for i in donate])


# ---------------------------------------------------------------------------
# the elastic adapter: pin-per-world step functions
# ---------------------------------------------------------------------------


class ElasticStep:
    """A ``(state, step, comm)`` step function that runs as a pinned
    program per world, for ``resilience/elastic.py:run``.

    The state contract is the elastic loop's: ``state`` is a replicated
    nest of tensors (identical on every rank, parameters after a gradient
    allreduce).  The port's state is rank-local already, so a call passes
    it to the pin as it is (the JAX package tiles it to its global
    convention and takes rank 0's row back).  The step index rides as a
    0-d int32 tensor on the state's device, so stepping never re-pins.

    The first call pins ``fn`` over the comm it is handed: on one CUDA
    rank a CUDA graph, on the CPU and on several ranks the body run
    eagerly, as every pin runs there (``compile``).  When the world moves
    (``elastic.run`` hands a NEW comm after a shrink: another
    ``(comm.uid, comm.epoch)``) the next call raises
    ``StaleProgramError`` (MPX129) and ``repin()`` drops the pin;
    ``elastic.run`` re-pins and retries the same step, so an elastic loop
    keeps its pinned hot path across epochs.  A knob or an override moved
    since the pin raises the same way (the pin's own stamp).

    ``unroll=N`` pins a megastep: each call runs N consecutive
    ``fn(state, step + i, comm)`` iterations (``parallel/megastep.py``;
    one graph on one CUDA rank) and returns the state after step
    ``step + N``.  ``elastic.run`` reads ``unroll``, rounds
    ``commit_every`` up to a multiple of N and advances N steps a call;
    a stale pin retries the whole megastep from the same state.
    """

    def __init__(self, fn, donate_state: bool = False, unroll: int = 1):
        from ..parallel.megastep import validate_unroll

        self._fn = fn
        self._donate_state = donate_state
        self.unroll = validate_unroll(unroll)
        self._pinned: Optional[PinnedProgram] = None
        self._world_key = None

    @staticmethod
    def _device(state, comm):
        for t in tree_leaves(state):
            if isinstance(t, torch.Tensor):
                return t.device
        return comm.device

    def __call__(self, state, step: int, comm):
        pinned = self._pinned
        key = (comm.uid, comm.epoch)
        if pinned is not None and self._world_key != key:
            from ..ops._base import mpx_error
            from .invalidation import StaleProgramError

            _stats.stale_raises += 1
            raise mpx_error(
                StaleProgramError, "MPX129",
                f"pinned elastic step {getattr(self._fn, '__name__', 'fn')!r} "
                f"was handed a different communicator (uid/epoch "
                f"{self._world_key} -> {key}): the world moved — repin() and "
                "retry (elastic.run does this itself)",
            )
        step_t = torch.full((), int(step), dtype=torch.int32,
                            device=self._device(state, comm))
        if pinned is None:
            fn, n_unroll = self._fn, self.unroll

            def per_rank(st, step_scalar):
                if n_unroll == 1:
                    return fn(st, step_scalar, comm)
                from ..parallel.megastep import megastep_loop

                def one(i, carry):
                    return fn(carry, step_scalar + i, comm)

                return megastep_loop(one, st, n_unroll, comm,
                                     label=getattr(fn, "__name__", "fn"))

            per_rank.__name__ = getattr(fn, "__name__", "fn")
            # unroll=1 on purpose: the loop (when any) is built above, and
            # MPI4JAX_TPU_UNROLL_DEFAULT must not wrap a second one round it
            self._pinned = pinned = compile(
                per_rank, state, step_t, comm=comm,
                donate_argnums=(0,) if self._donate_state else (), unroll=1)
            self._world_key = key
        return pinned(state, step_t)

    def repin(self) -> "ElasticStep":
        """Drop the pin; the next call pins against the comm (and state
        shapes) it is handed."""
        self._pinned = None
        self._world_key = None
        return self

    @property
    def pinned(self) -> Optional[PinnedProgram]:
        """The current pin (``None`` before the first call and after
        ``repin``)."""
        return self._pinned


def compile_step(fn, *, donate_state: bool = False,
                 unroll: int = 1) -> ElasticStep:
    """Adapt a per-rank ``fn(state, step, comm)`` for ``elastic.run`` with
    a pinned hot path (see ``ElasticStep``).  ``donate_state`` donates
    the state into each call (on one CUDA rank the graph then writes the
    new state into the buffers it was given, and the call returns them).
    ``unroll=N`` makes each call a megastep of N iterations; ``elastic.run``
    aligns its commit cadence to it."""
    return ElasticStep(fn, donate_state=donate_state, unroll=unroll)
