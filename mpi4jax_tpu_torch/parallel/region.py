"""Parallel regions: the scope that gives ops a default comm, and that
fusion and overlap flush at its end.

PyTorch counterpart of ``mpi4jax_tpu/parallel/region.py``.  There,
``spmd`` traces one program for every rank with ``jax.shard_map``; here
each process already is one rank and runs its ops as it calls them, so
``spmd(comm=...)`` is an eager scope around a call of the function:

- inside it, an op called with ``comm=None`` takes the region's comm
  (outside any region such a call raises, as before);
- it holds the fusion queue (``ops/_fusion.py``) and the async starts of
  the region (``ops/_async.py``);
- at its end it issues what is still queued, turns every deferred result
  among the outputs into its tensor, and waits for every start: a start
  that its function never waited raises MPX112, as the JAX package's
  verifier flags it.

``spmd(static_argnums=, unroll=N)`` runs a megastep
(``parallel/megastep.py``): the dynamic positional arguments are the
carry, and the function runs N times, each output the next call's
arguments.  ``unroll=None`` takes ``MPI4JAX_TPU_UNROLL_DEFAULT`` (1, no
loop, by default).  With ``unroll=1`` the region calls the function once
as it was called, statics and keywords included: the same launches and
exchanges as before the megastep layer.  ``aot/pinning.py:compile`` runs
the same region body (``region_body``), captured as a CUDA graph on one
CUDA rank.

Every rank must run the same regions and, in each, the same collectives
in the same order: the queue is issued at the same point of the program
on every rank.  ``spmd`` takes no ``in_specs``/``out_specs`` or ``jit``:
each process holds its rank's tensors, and there is no trace to shard.
"""

from __future__ import annotations

import functools
from typing import List, Optional

from .comm import Comm
from .mesh import DEFAULT_AXIS, _world_key, get_default_mesh


class RegionContext:
    """The state of one region: its comm, the fusion queue (``None`` when
    empty) and the async starts issued in it."""

    def __init__(self, comm: Comm):
        self.comm = comm
        self.fusion_queue = None
        self.handles: list = []
        # (loop id, iteration) while a megastep iteration runs in it, and
        # the loop's trip count (recorded by an abstract run, analysis/)
        self.megastep = None
        self.megastep_unroll = None


_region_stack: List[RegionContext] = []
_default = (None, None)  # (the world it was built in, the comm)


def current_context() -> Optional[RegionContext]:
    """The innermost region's context, ``None`` outside every region."""
    return _region_stack[-1] if _region_stack else None


def get_default_comm() -> Comm:
    """Inside a region, its comm; outside, the world's comm over the
    default grid (``get_default_mesh``: a 1-D grid named ``"mpi4jax"``;
    built once per world; every rank must ask for it, since building a
    grid of several ranks is collective)."""
    ctx = current_context()
    if ctx is not None:
        return ctx.comm
    global _default
    world = _world_key()
    if _default[1] is None or _default[0] != world:
        _default = (world, Comm(DEFAULT_AXIS, mesh=get_default_mesh()))
    return _default[1]


def resolve_comm(comm: Optional[Comm]) -> Comm:
    return comm if comm is not None else get_default_comm()


def normalize_statics(static_argnums, nargs: int) -> tuple:
    """``static_argnums`` as ascending non-negative positions of ``nargs``
    arguments; ``ValueError`` for one out of range."""
    if static_argnums is None:
        raw = ()
    elif isinstance(static_argnums, int):
        raw = (static_argnums,)
    else:
        raw = tuple(static_argnums)
    statics = tuple(sorted({i if i >= 0 else i + nargs for i in raw}))
    for i in statics:
        if not 0 <= i < nargs:
            raise ValueError(
                f"static_argnums entry {i} out of range for {nargs} "
                "positional arguments"
            )
    return statics


def resolve_unroll(unroll, n_dyn: int, kw_names=(), what: str = "spmd") -> int:
    """The trip count of a region: ``unroll`` validated, or the default of
    ``MPI4JAX_TPU_UNROLL_DEFAULT``.  A body that cannot carry a loop
    (keyword arguments, no dynamic argument) raises under an explicit
    ``unroll > 1`` and runs once under the default, as in the JAX
    package: a fleet-wide default must not break unrelated programs."""
    from ..utils.config import unroll_default
    from .megastep import validate_unroll

    n = validate_unroll(unroll) if unroll is not None else unroll_default()
    if n > 1 and (kw_names or n_dyn == 0):
        if unroll is None:
            return 1
        if kw_names:
            raise TypeError(
                f"{what}(unroll=N) takes positional arguments only (got "
                f"keyword argument(s) {tuple(kw_names)}): the megastep carry "
                "is the dynamic positional tuple"
            )
        raise ValueError(
            f"{what}(unroll=N) needs at least one dynamic argument to carry "
            "through the megastep loop"
        )
    return n


def region_body(f, c: Comm, statics, static_vals, unroll: int = 1):
    """The per-rank body ``spmd`` runs and ``compile`` pins: called with
    the dynamic positional arguments (and keywords, at ``unroll == 1``), it
    pushes a region over ``c``, re-inserts the statics, runs ``f`` once or
    as a megastep loop of ``unroll`` iterations, then flushes the fusion
    queue, turns deferred results into tensors and closes the async
    starts.  Under the verifier's ambient mode (``MPI4JAX_TPU_ANALYZE``)
    the body is first verified abstractly, once per key, before it runs
    (``analysis/crossrank.py:verify_region``)."""
    label = getattr(f, "__name__", "fn")

    def full_args(dyn):
        full = list(dyn)
        for i, v in zip(statics, static_vals):
            full.insert(i, v)
        return full

    def body(*dyn, **kwargs):
        from ..ops import _async, _base, _fusion
        from .megastep import megastep_loop

        h = _base.hooks()
        if h is not None and h.analyze and not h.collect:
            from ..analysis.crossrank import verify_region

            verify_region(f, c, statics, static_vals, unroll, dyn, kwargs,
                          body)
        ctx = RegionContext(c)
        _region_stack.append(ctx)
        try:
            if unroll > 1:
                n_dyn = len(dyn)

                def one(_i, carry):
                    r = f(*full_args(carry))
                    if n_dyn == 1:
                        return (r,)
                    if not isinstance(r, (tuple, list)) or len(r) != n_dyn:
                        raise ValueError(
                            f"megastep carry contract violated in {label!r}: "
                            f"with unroll={unroll} and {n_dyn} dynamic "
                            f"arguments the step must return a matching "
                            f"{n_dyn}-tuple of new states, got "
                            f"{type(r).__name__}"
                        )
                    return tuple(r)

                final = megastep_loop(one, tuple(dyn), unroll, c, label=label)
                out = final[0] if n_dyn == 1 else final
            else:
                out = f(*full_args(dyn), **kwargs)
            _fusion.flush_pending(ctx)
            out = _fusion.materialize_tree(out)
            _async.finish_region(ctx)
            return out
        finally:
            _region_stack.pop()

    return body


def spmd(fn=None, *, comm: Optional[Comm] = None, static_argnums=(),
         unroll: Optional[int] = None):
    """Run the decorated function as a region over ``comm`` (``None``: the
    enclosing region's comm, else the world's).  Usable bare (``@spmd``)
    or with arguments (``@spmd(comm=c)``).

    ``unroll=N`` (N > 1) runs a megastep: the dynamic positional arguments
    are the carry and the function runs N times, each output the next
    iteration's arguments (a like-structured tuple when there are
    several); the arguments named by ``static_argnums`` are passed to every
    iteration unchanged, and keyword arguments are refused.  ``None``
    takes ``MPI4JAX_TPU_UNROLL_DEFAULT``."""

    def wrap(f):
        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            c = resolve_comm(comm)
            try:
                statics = normalize_statics(static_argnums, len(args))
            except ValueError:
                _refuse_keyword_static(f, static_argnums, kwargs)
                raise
            static_vals = tuple(args[i] for i in statics)
            try:
                hash(static_vals)
            except TypeError as e:
                raise TypeError(
                    "spmd static argument values must be hashable (like "
                    f"jax.jit static_argnums); got {static_vals!r}"
                ) from e
            dyn = tuple(a for i, a in enumerate(args) if i not in statics)
            n = resolve_unroll(unroll, len(dyn), tuple(sorted(kwargs)))
            if n == 1:
                # the body unchanged: f called as it was called
                return region_body(f, c, (), (), 1)(*args, **kwargs)
            return region_body(f, c, statics, static_vals, n)(*dyn)

        # breadcrumbs for compile, which adopts them
        wrapped._mpx_spmd = True
        wrapped._mpx_fn = f
        wrapped._mpx_spmd_kwargs = dict(comm=comm, static_argnums=static_argnums,
                                        unroll=unroll)
        return wrapped

    return wrap(fn) if fn is not None else wrap


def _refuse_keyword_static(f, static_argnums, kwargs) -> None:
    """A static argument passed by keyword gets its own error, as in
    ``jax.jit``."""
    import inspect

    names = list(inspect.signature(f).parameters)
    raw = (static_argnums,) if isinstance(static_argnums, int) else static_argnums
    for i in raw:
        if 0 <= i < len(names) and names[i] in kwargs:
            raise TypeError(
                f"spmd static argument {names[i]!r} (static_argnums position "
                f"{i}) was passed as a keyword; pass it positionally"
            )


def in_parallel_region(comm: Comm) -> bool:
    """True inside a region whose grid has every axis of ``comm`` (the
    JAX package's test that the comm's axes are bound in the trace)."""
    ctx = current_context()
    if ctx is None:
        return False
    mesh = ctx.comm.mesh
    return mesh is not None and set(comm.axes) <= set(mesh.axes)


def run(f, *args, comm: Optional[Comm] = None, **kwargs):
    """One-shot ``spmd``: ``run(f, x)`` is ``spmd(f, comm=comm)(x)``."""
    return spmd(comm=comm)(f)(*args, **kwargs)
