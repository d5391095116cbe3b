"""Deterministic fault injection at the port's shared dispatch point.

PyTorch counterpart of ``mpi4jax_tpu/resilience/faultinject.py``, with
its spec grammar, its clause semantics and its per-rank call counting:
every op of the port goes through ``ops/_base.py:run_body``, which probes
the parsed spec before the op's exchange (``resilience/runtime.py``), so
every op is injectable with one environment variable.

Spec grammar (``MPI4JAX_TPU_FAULT_SPEC``)::

    spec    := clause (';' clause)*
    clause  := verb (':' arg)* | 'die-host' ':' host ['@' op#]
    verb    := 'delay' | 'die' | 'hang' | 'corrupt' | 'preempt'
    arg     := 'nan' | 'inf' | key '=' value      # bare modes only for corrupt
    key     := 'rank' | 'host' | 'op' | 'after' | 'secs' | 'grace'

Examples::

    delay:rank=1:op=allreduce:after=3:secs=2   # rank 1 sleeps 2s in every
                                               # allreduce after its 3rd
    die:rank=0:op=barrier:after=1              # rank 0 exits in its 2nd barrier
    corrupt:nan:rank=2:op=allreduce            # rank 2 feeds NaN inputs
    die-host:1@3                               # every rank of host 1 exits in
                                               # its 4th op (== die:host=1
                                               # :after=3)

Semantics:

- ``rank`` is the global rank (the ``torch.distributed`` rank); omitted =
  every rank.  ``host`` scopes a clause to every rank that
  ``MPI4JAX_TPU_TOPOLOGY`` maps to that host (exclusive with ``rank``);
  without a declared topology a host clause matches nothing and warns
  once (the port has no topology of its own yet).
- ``op`` is the lowercase op name as dispatched (``allreduce``,
  ``sendrecv``, ...); omitted = every op.
- ``after=N``: the first N matching calls (counted per rank) run clean;
  the fault fires on every matching call after that.
- ``delay`` sleeps ``secs`` (default 1.0) before the op; ``die`` exits
  the process with code 13 (``os._exit``); ``hang`` sleeps forever (the
  peers see only silence, which their watchdogs turn into a death);
  ``corrupt`` overwrites the op's floating-point inputs with NaN (``nan``,
  the default) or +Inf (``inf``) on the firing rank, on the tensors'
  device; ``preempt`` posts a drain notice for the current rank
  (``elastic.request_drain(grace, rank=)``) and the op proceeds: the
  elastic loop drains the rank at its next step boundary.
- ``rank`` names a rank of the world the job was launched with: after an
  elastic shrink renumbered the survivors (``resilience/elastic.py``),
  each survivor is matched by its launch rank (``elastic.origin_rank``),
  so a clause that hung rank 2 does not hang the survivor renumbered 2.
"""

from __future__ import annotations

import functools
import os
import sys
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

_VERBS = ("delay", "die", "hang", "corrupt", "preempt")
_KEYS = ("rank", "host", "op", "after", "secs", "grace")
_MODES = ("nan", "inf")

_GRAMMAR = (
    "expected 'verb[:arg]*' clauses joined by ';', verb in "
    f"{_VERBS}, args 'key=value' with key in {_KEYS} (plus a bare "
    f"mode in {_MODES} for corrupt; 'secs' only for delay, 'grace' "
    "only for preempt; 'rank' and 'host' are mutually exclusive), or "
    "the host-kill shorthand 'die-host:<h>[@<op#>]' — e.g. "
    "'delay:rank=1:op=allreduce:after=3:secs=2' or 'die-host:1@3'"
)


@dataclass(frozen=True)
class FaultClause:
    """One parsed fault clause (see module docstring for field semantics)."""

    verb: str
    mode: Optional[str] = None  # corrupt only: 'nan' | 'inf'
    rank: Optional[int] = None  # global rank; None = all ranks
    host: Optional[int] = None  # topology host id; None = no host scope
    op: Optional[str] = None    # lowercase dispatch op name; None = all ops
    after: int = 0
    secs: float = 1.0           # delay only
    grace: Optional[float] = None  # preempt only: peer-ack budget seconds

    def matches_op(self, opname: str) -> bool:
        return self.op is None or self.op == opname

    def canonical(self) -> str:
        """Canonical spec string; ``parse_fault_spec`` round-trips it
        (the ``die-host`` shorthand canonicalizes to its ``die:host=``
        long form)."""
        parts = [self.verb]
        if self.verb == "corrupt":
            parts.append(self.mode or "nan")
        if self.rank is not None:
            parts.append(f"rank={self.rank}")
        if self.host is not None:
            parts.append(f"host={self.host}")
        if self.op is not None:
            parts.append(f"op={self.op}")
        if self.after:
            parts.append(f"after={self.after}")
        if self.verb == "delay":
            parts.append(f"secs={self.secs:g}")
        if self.verb == "preempt" and self.grace is not None:
            parts.append(f"grace={self.grace:g}")
        return ":".join(parts)


def _parse_clause(text: str) -> FaultClause:
    fields = [f.strip() for f in text.split(":")]
    verb = fields[0]
    if verb == "die-host":
        # shorthand: die-host:<h>[@<op#>] == die:host=<h>[:after=<op#>]
        if len(fields) != 2 or not fields[1]:
            raise ValueError(
                f"fault spec clause {text!r}: die-host takes exactly "
                f"'<host>[@<op#>]'; {_GRAMMAR}")
        h_s, sep, after_s = fields[1].partition("@")
        try:
            host = int(h_s)
            after = int(after_s) if sep else 0
        except ValueError as e:
            raise ValueError(
                f"fault spec clause {text!r}: bad die-host operand "
                f"{fields[1]!r}; {_GRAMMAR}") from e
        if host < 0 or after < 0:
            raise ValueError(
                f"fault spec clause {text!r}: host and op# must be >= 0")
        return FaultClause(verb="die", host=host, after=after)
    if verb not in _VERBS:
        raise ValueError(
            f"fault spec clause {text!r}: unknown verb {verb!r}; {_GRAMMAR}"
        )
    mode = None
    kw = {}
    for field in fields[1:]:
        if not field:
            raise ValueError(f"fault spec clause {text!r}: empty field; {_GRAMMAR}")
        if "=" not in field:
            if verb == "corrupt" and field in _MODES and mode is None:
                mode = field
                continue
            raise ValueError(
                f"fault spec clause {text!r}: bare field {field!r} is only "
                f"valid as a corrupt mode in {_MODES}; {_GRAMMAR}"
            )
        key, _, value = field.partition("=")
        key, value = key.strip(), value.strip()
        if key not in _KEYS:
            raise ValueError(
                f"fault spec clause {text!r}: unknown key {key!r}; {_GRAMMAR}"
            )
        if key in kw:
            raise ValueError(f"fault spec clause {text!r}: duplicate key {key!r}")
        try:
            if key == "rank":
                kw["rank"] = int(value)
            elif key == "host":
                kw["host"] = int(value)
            elif key == "after":
                kw["after"] = int(value)
            elif key == "secs":
                kw["secs"] = float(value)
            elif key == "grace":
                kw["grace"] = float(value)
            else:
                kw["op"] = value.lower()
        except ValueError as e:
            raise ValueError(
                f"fault spec clause {text!r}: bad value for {key}: {value!r}"
            ) from e
    if "rank" in kw and "host" in kw:
        raise ValueError(
            f"fault spec clause {text!r}: 'rank' and 'host' are mutually "
            "exclusive (a host clause already names every rank on that "
            "host)"
        )
    if kw.get("host") is not None and kw["host"] < 0:
        raise ValueError(f"fault spec clause {text!r}: host must be >= 0")
    if verb != "delay" and "secs" in kw:
        raise ValueError(
            f"fault spec clause {text!r}: 'secs' only applies to delay"
        )
    if verb != "preempt" and "grace" in kw:
        raise ValueError(
            f"fault spec clause {text!r}: 'grace' only applies to preempt"
        )
    if verb == "corrupt" and mode is None:
        mode = "nan"
    if kw.get("after", 0) < 0:
        raise ValueError(f"fault spec clause {text!r}: after must be >= 0")
    if kw.get("secs", 1.0) < 0:
        raise ValueError(f"fault spec clause {text!r}: secs must be >= 0")
    if kw.get("grace") is not None and kw["grace"] <= 0:
        raise ValueError(f"fault spec clause {text!r}: grace must be > 0")
    return FaultClause(verb=verb, mode=mode, **kw)


@functools.lru_cache(maxsize=32)
def parse_fault_spec(spec: str) -> Tuple[FaultClause, ...]:
    """Parse a ``MPI4JAX_TPU_FAULT_SPEC`` string into clauses.

    Raises ``ValueError`` (with the grammar) on malformed specs; '' -> ().
    """
    spec = spec.strip()
    if not spec:
        return ()
    return tuple(
        _parse_clause(c.strip()) for c in spec.split(";") if c.strip()
    )


def canonical_spec(clauses: Tuple[FaultClause, ...]) -> str:
    return ";".join(c.canonical() for c in clauses)


# one nap at a time (not one giant sleep): a hung rank stays
# interruptible between naps.  Patchable in tests so "forever" can be
# observed finitely.
_HANG_NAP_SECS = 1.0


def _hang_forever():  # pragma: no cover - exercised via drills/monkeypatch
    while True:
        time.sleep(_HANG_NAP_SECS)


# ---------------------------------------------------------------------------
# host-side trigger state
# ---------------------------------------------------------------------------


class _FaultState:
    """Per-process matching-call counters: (clause identity, rank) -> count.

    The count only advances for calls the clause matches (op and rank), so
    ``after=N`` means "the first N calls this fault WOULD hit run clean".
    """

    def __init__(self):
        self.lock = threading.Lock()
        self.counts = {}

    def bump(self, clause: FaultClause, rank: int) -> int:
        key = (clause, rank)
        with self.lock:
            n = self.counts.get(key, 0) + 1
            self.counts[key] = n
        return n

    def reset(self) -> None:
        with self.lock:
            self.counts.clear()


_state = _FaultState()


def reset_fault_state() -> None:
    """Forget all per-rank trigger counts (test isolation)."""
    _state.reset()
    global _warned_no_topology
    _warned_no_topology = False


_warned_no_topology = False


def _rank_on_host(rank: int, host: int) -> bool:
    """Whether the declared ``MPI4JAX_TPU_TOPOLOGY`` spec maps ``rank``
    to ``host``.  No spec (or a rank past the spec's coverage) matches
    nothing — with a one-time warning, because a host-scoped drill that
    silently no-ops would report false confidence."""
    from ..utils import config

    counts = config.parse_topology_spec(config.topology_spec())
    if counts is None:
        global _warned_no_topology
        if not _warned_no_topology:
            _warned_no_topology = True
            warnings.warn(
                "fault spec uses a host-scoped clause but "
                "MPI4JAX_TPU_TOPOLOGY is not set — the clause matches no "
                "rank (set the topology spec so host ids are defined)",
                RuntimeWarning, stacklevel=3)
        return False
    edge = 0
    for h, c in enumerate(counts):
        edge += c
        if rank < edge:
            return h == host
    return False


def _fault_line(rank: int, text: str) -> None:
    print(f"r{rank} | FAULT | {text}", file=sys.stderr, flush=True)
    # injections are telemetry incidents too (metered; an events-tier
    # instant puts them on the merged timeline next to the op they hit)
    from ..telemetry import journal

    journal.incident("faults.injected", "fault", rank, text)


def probe_host(indexed_clauses, mpi_name: str, rank) -> int:
    """Host-side trigger: count, act (delay/die), and return the corrupt mask.

    ``indexed_clauses``: tuple of (bit, clause) for clauses whose ``op``
    matches the dispatching op.  Returns a bitmask with bit ``b`` set iff
    the corrupt clause at bit ``b`` fires for this rank on this call.
    ``rank`` is the current global rank, matched by its launch rank.
    """
    from .elastic import origin_rank

    r = origin_rank(int(rank))
    mask = 0
    for bit, clause in indexed_clauses:
        if clause.rank is not None and clause.rank != r:
            continue
        if clause.host is not None and not _rank_on_host(r, clause.host):
            continue
        if _state.bump(clause, r) <= clause.after:
            continue
        if clause.verb == "delay":
            _fault_line(r, f"delay {clause.secs:g}s injected in {mpi_name} "
                           f"({clause.canonical()})")
            time.sleep(clause.secs)
        elif clause.verb == "die":
            _fault_line(r, f"die injected in {mpi_name} "
                           f"({clause.canonical()})")
            # the last chance for a postmortem bundle: os._exit skips
            # every finally (a no-op unless the health plane is on; a
            # fault probe must not die of its observers)
            try:
                from ..telemetry import health as _health

                _health.maybe_postmortem(
                    f"fatal_fault: die injected in {mpi_name} on rank {r}")
            except Exception:
                pass
            sys.stderr.flush()
            os._exit(13)
        elif clause.verb == "hang":
            _fault_line(r, f"hang injected in {mpi_name} "
                           f"({clause.canonical()}) — sleeping forever")
            # the bundle now: the hung rank blocks before its watchdog arm,
            # so this is its one postmortem, with the fault incident at the
            # ring's tail, which the postmortem command names it from
            try:
                from ..telemetry import health as _health

                _health.maybe_postmortem(
                    f"fault: hang injected in {mpi_name} on rank {r}")
            except Exception:
                pass
            sys.stderr.flush()
            _hang_forever()
        elif clause.verb == "preempt":
            _fault_line(r, f"preempt notice injected in {mpi_name} "
                           f"({clause.canonical()}) — drain at next "
                           "step boundary")
            # the SIGTERM-style path: post the drain and let the collective
            # proceed; the elastic loop executes the planned shrink at its
            # next step boundary.  The notice names the CURRENT rank (the
            # loop compares it with its process id), not the launch rank
            # the clause matched.
            from .elastic import request_drain

            request_drain(clause.grace, rank=int(rank))
        else:  # corrupt
            _fault_line(r, f"corrupt:{clause.mode} injected in {mpi_name} "
                           f"({clause.canonical()})")
            mask |= 1 << bit
    return mask


def apply_corrupt(arrays, indexed_clauses, mask: int):
    """The op's inputs after the corrupt clauses whose bits ``mask`` sets:
    every floating tensor filled with NaN (``nan``) or +Inf (``inf``) on
    its own device, as the JAX package's ``Plan._apply_corrupt`` fills
    them; other tensors pass unchanged."""
    import torch

    out = list(arrays)
    for bit, clause in indexed_clauses:
        if clause.verb != "corrupt" or not (mask >> bit) & 1:
            continue
        fill = float("nan") if clause.mode == "nan" else float("inf")
        out = [torch.full_like(a, fill)
               if isinstance(a, torch.Tensor) and a.is_floating_point() else a
               for a in out]
    return tuple(out)
