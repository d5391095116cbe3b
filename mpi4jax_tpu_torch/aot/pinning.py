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

The JAX package's persistent tier (its disk cache, serialization, C++
fast path, cache warming) and ``compile_step`` wait: ROADMAP Queue 1
item 6.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..kernels import _build
from ..ops._base import per_op_hook as _per_op_hook
from ..telemetry import core as _telemetry
from ..utils.tree import tree_flatten, tree_leaves
from . import keys
from .invalidation import WorldStamp

__all__ = ["PinnedProgram", "compile", "stats", "reset_stats"]


class _Stats:
    __slots__ = ("pins", "calls", "stale_raises", "replays", "copied_bytes",
                 "eager_pins")

    def __init__(self):
        self.reset()

    def reset(self):
        self.pins = 0
        self.calls = 0
        self.stale_raises = 0
        self.replays = 0
        self.copied_bytes = 0
        self.eager_pins = 0


_stats = _Stats()


def stats() -> dict:
    """Pinning counters: ``pins`` (programs pinned), ``calls`` (pinned
    calls), ``stale_raises`` (MPX129 refusals), ``replays`` (CUDA-graph
    replays), ``copied_bytes`` (bytes copied into and out of graphs by
    calls) and ``eager_pins`` (pins on one CUDA rank that run eagerly under
    a per-op host hook; ``program.info`` names the knob)."""
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

    def __init__(self, body, dyn: tuple, name: str, reason: Optional[str] = None):
        self.body = body
        self.name = name
        self.signature = _signature(tree_leaves(tuple(dyn)))
        self.bytes_copied = 0
        self.reason = reason

    def __call__(self, *dyn):
        _check_signature(self.name, self.signature, tree_leaves(tuple(dyn)))
        return self.body(*dyn)


class PinnedProgram:
    """A pinned program: ``program(*dynamic_args)`` checks the captured
    world (one epoch compare, one compare of the raw variables) and
    replays the graph, or runs the body on the CPU or several ranks.
    Statics were folded at pin time: call with the dynamic arguments only,
    shaped as the examples given to ``compile``.  ``unroll`` is the
    megastep trip count (1: one step a call); ``graph`` says whether calls
    replay a CUDA graph; ``bytes_copied`` is what the last call copied."""

    __slots__ = ("_run", "_world", "_respec", "fn_name", "key",
                 "donate_argnums", "unroll")

    def __init__(self, run, world: WorldStamp, respec, fn_name: str, key,
                 donate_argnums, unroll: int):
        self._run = run
        self._world = world
        self._respec = respec
        self.fn_name = fn_name
        self.key = key
        self.donate_argnums = donate_argnums
        self.unroll = unroll

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


def program_key(name: str, fn, dyn_leaves, static_vals, comm, unroll: int,
                donate) -> str:
    """What a pin captured, as one key: the function, the dynamic
    arguments' shapes, dtypes and devices, the static values, the comm
    and the unroll."""
    static_vals = tuple(_keyable(v) for v in static_vals)
    sig = tuple((tuple(t.shape), str(t.dtype), str(t.device))
                if isinstance(t, torch.Tensor) else (type(t).__name__,)
                for t in dyn_leaves)
    mesh = None
    if comm is not None:
        grid = comm.mesh
        mesh = (tuple(comm.axes), comm.uid,
                None if grid is None else (tuple(grid.shape), tuple(grid.axes),
                                           grid.rank, str(grid.device)))
    where = f"{getattr(fn, '__module__', '')}.{getattr(fn, '__qualname__', name)}"
    return keys.derive_key(keys.fingerprint(where), mesh,
                           (sig, static_vals, unroll, tuple(donate)),
                           (torch.__version__, torch.version.cuda))


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

    # captured before the warm-up: a knob moved during the pin leaves a
    # stamp that refuses the first call
    world = WorldStamp.capture()
    leaves = tree_leaves(dyn)
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    device = tensors[0].device if tensors else (c.device if c is not None else None)
    on_card = device is not None and device.type == "cuda" and _one_rank_world()
    per_op = _per_op_hook() if on_card else None
    if on_card and per_op is None:
        alias = bool(dyn) and set(donate) == set(
            i for i in range(len(example_args)) if i not in statics)
        run = GraphRun(body, dyn, name, alias, pool)
    else:
        run = EagerRun(body, dyn, name, per_op)
        if per_op is not None:
            _stats.eager_pins += 1
            _telemetry.meter("aot.eager_pins")
    _stats.pins += 1
    key = program_key(name, inner, leaves, static_vals, c, n_unroll, donate)

    def respec():
        return compile(fn, *example_args, **spec)

    return PinnedProgram(run, world, respec, name, key, donate, n_unroll)
