"""Megastep execution: N steps for one call.

PyTorch counterpart of ``mpi4jax_tpu/parallel/megastep.py``.  There
``compile(fn, unroll=N)`` and ``spmd(..., unroll=N)`` rewrite the step
into a device-resident ``lax.fori_loop`` of N iterations, so one host
dispatch runs N steps.  Here ``megastep_loop`` runs the N iterations in
Python; on one CUDA rank ``compile`` captures all N into one CUDA graph
(``aot/pinning.py``), so a replay launches N steps' kernels for one host
call, the CUDA-graph form of the same idea.  Everywhere else (the CPU,
several ranks) the loop runs eagerly with the same contracts:

- **carry contract**: the body maps its carry (the dynamic positional
  arguments) to an output of the same structure, shapes and dtypes; a
  mismatch raises ``ValueError`` naming the leaf, after the first
  iteration that breaks it;
- **per-iteration fusion**: the fusion queue (``ops/_fusion.py``) is
  flushed and every deferred result turned into its tensor at the end of
  each iteration, so no bucket packs members of two iterations;
- **span rule**: an async ``*_start`` must be waited in its own
  iteration.  The JAX package's MPX130 checker finds a straddling span
  in the traced body; with no trace to check, the port raises MPX130 at
  the iteration's end for a start still in flight, and at a wait whose
  start belongs to another iteration or to no loop
  (``ops/_async.py:close_iteration``);
- **the trailing barrier**: the JAX package ties a tokenless barrier left
  at an iteration's end into the carry so that it is not dropped; the
  port's ``barrier`` runs where it is called, so every iteration's
  barrier has run by its end and there is nothing to tie.

``unroll == 1`` calls the body once, with no loop machinery: the same
launches and exchanges as a call without this layer.

Around the whole loop, as in the JAX package: with the watchdog on, one
entry ``MPI_Megastep[label]`` armed with the deadline ``timeout * N``
(the per-op arms inside the loop are untouched) and disarmed when the
loop ends or raises; in the ``events`` tier, one journal record per
megastep call (``op: "megastep"``, with ``unroll`` and ``label``), whose
latency over N the journal keeps as the per-step estimate.  Neither runs
inside a CUDA-graph capture: both services make a pin run eagerly
(``aot/pinning.py``).
"""

from __future__ import annotations

import itertools

import torch

from ..utils.tree import tree_leaves

__all__ = ["megastep_loop", "register_boundary_hook",
           "run_boundary_hooks", "tracing_megastep", "validate_unroll"]

_loop_ids = itertools.count(1)

# ---------------------------------------------------------------------------
# megastep boundary hooks (host side)
# ---------------------------------------------------------------------------
#
# A boundary is the host-side gap between two megastep calls, the one
# point where anything outside the program can act: the loop that owns
# the boundary calls ``run_boundary_hooks(step, **info)`` once per
# boundary, and every registered hook fires in registration order.

_boundary_hooks: list = []   # (name, fn)


def register_boundary_hook(name: str, fn):
    """Register ``fn(step, **info)`` to run at every megastep boundary a
    loop publishes.  Returns a zero-argument unregister callable.  A
    hook's exception propagates to that loop, which must stop."""
    if not callable(fn):
        raise TypeError(f"boundary hook {name!r} must be callable")
    entry = (str(name), fn)
    _boundary_hooks.append(entry)

    def unregister():
        try:
            _boundary_hooks.remove(entry)
        except ValueError:
            pass

    return unregister


def run_boundary_hooks(step: int, **info) -> list:
    """Fire every registered hook for boundary ``step``; returns
    ``[(name, result), ...]`` in registration order."""
    return [(name, fn(step, **info)) for name, fn in list(_boundary_hooks)]


# nesting depth of megastep iterations being run (or captured)
_megastep_depth = 0


def tracing_megastep() -> bool:
    """True while an iteration of a megastep loop runs, or is captured
    into a CUDA graph."""
    return _megastep_depth > 0


def validate_unroll(unroll) -> int:
    """Normalize an ``unroll=`` argument: a positive int (1 = no loop)."""
    try:
        n = int(unroll)
    except (TypeError, ValueError):
        raise TypeError(
            f"unroll must be a positive integer, got {unroll!r}"
        ) from None
    if n < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll!r}")
    return n


class _iteration_scope:
    """One iteration of a loop: bumps the module depth and stamps the
    region context with ``(loop_id, iteration)``, which every async start
    issued inside records (``ops/_async.py``)."""

    __slots__ = ("ctx", "scope", "saved")

    def __init__(self, ctx, scope):
        self.ctx = ctx
        self.scope = scope
        self.saved = None

    def __enter__(self):
        global _megastep_depth
        _megastep_depth += 1
        if self.ctx is not None:
            self.saved = self.ctx.megastep
            self.ctx.megastep = self.scope
        return self

    def __exit__(self, *exc):
        global _megastep_depth
        _megastep_depth -= 1
        if self.ctx is not None:
            self.ctx.megastep = self.saved
        return False


def _structure(tree):
    """A comparable description of a container's structure (leaves as
    ``None``), in the flattening order of ``utils/tree.py``."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return None


def _leaf_signature(leaf):
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype))
    return ((), type(leaf).__name__)


def _carry_signature(tree):
    return _structure(tree), tuple(_leaf_signature(v) for v in tree_leaves(tree))


def _check_carry(struct0, sig0, out, label: str) -> None:
    struct1, sig1 = _carry_signature(out)
    if struct1 != struct0:
        raise ValueError(
            f"megastep carry contract violated in {label!r}: the loop "
            f"body returned structure {struct1} but its carry (the "
            f"dynamic arguments) has structure {struct0}.  With unroll > 1 "
            "the step must map its state to a like-structured state."
        )
    for i, (got, want) in enumerate(zip(sig1, sig0)):
        if got != want:
            raise ValueError(
                f"megastep carry contract violated in {label!r}: carry "
                f"leaf {i} went in as shape/dtype {want} and came out as "
                f"{got}; a megastep carry must keep its shapes and dtypes."
            )


def megastep_loop(body_fn, carry, unroll: int, comm, label: str = "fn"):
    """Run ``carry = body_fn(i, carry)`` for ``unroll`` iterations inside
    the current region (``comm`` is the region's; it names the loop's
    comm in errors).  Returns the final carry.  ``unroll == 1`` is a
    single direct call."""
    n = validate_unroll(unroll)
    if n == 1:
        return body_fn(0, carry)

    from ..ops import _async, _fusion
    from .region import current_context

    ctx = current_context()
    loop_id = next(_loop_ids)
    struct0, sig0 = _carry_signature(carry)
    bracket = _LoopBracket.open(comm, n, label)
    try:
        for i in range(n):
            scope = (loop_id, i)
            with _iteration_scope(ctx, scope):
                out = body_fn(i, carry)
                # per-iteration drain: buckets stay per-iteration, and no
                # deferred result leaks into the next iteration's carry
                _fusion.flush_pending(ctx)
                out = _fusion.materialize_tree(out)
                _async.close_iteration(ctx, scope, label, comm)
            _check_carry(struct0, sig0, out, label)
            carry = out
    except BaseException:
        if bracket is not None:
            bracket.disarm()
        raise
    if bracket is not None:
        bracket.close()
    return carry


class _LoopBracket:
    """The whole loop's watchdog entry and events-tier journal record."""

    __slots__ = ("comm", "rank", "wd_call_id", "ev_call_id")

    @classmethod
    def open(cls, comm, n: int, label: str):
        """Arm and begin, or ``None`` when neither service is on."""
        from ..ops._base import hooks, next_call_id
        from ..resilience import runtime as _resilience

        h = hooks()
        if h is None:
            return None
        timeout = _resilience.effective_watchdog_timeout()
        if timeout is None and not h.events:
            return None
        b = cls()
        b.comm = comm
        b.rank = comm.global_rank(comm.Get_rank())
        b.wd_call_id = b.ev_call_id = None
        if timeout is not None:
            from ..resilience import watchdog

            b.wd_call_id = next_call_id()
            watchdog.arm(f"MPI_Megastep[{label}]", b.wd_call_id, comm, b.rank,
                         timeout * n)
        if h.events:
            from ..telemetry import journal

            b.ev_call_id = next_call_id()
            journal.begin(b.ev_call_id, b.rank, {
                "op": "megastep", "label": label, "unroll": n,
                "comm_uid": str(comm.uid), "axes": list(comm.axes),
                "bytes": 0, "dtype": ""})
        return b

    def disarm(self) -> None:
        if self.wd_call_id is not None:
            from ..resilience import watchdog

            watchdog.disarm(self.wd_call_id, self.rank)
            self.wd_call_id = None

    def close(self) -> None:
        if self.ev_call_id is not None:
            from ..telemetry import journal

            journal.end(self.ev_call_id, self.rank, {"algo": "loop"})
        self.disarm()
