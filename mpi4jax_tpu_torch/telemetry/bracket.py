"""Events-tier brackets: the journal's begin and end around one op call.

PyTorch counterpart of ``mpi4jax_tpu/telemetry/bracket.py``.  There the
begin and end are ``io_callback``\\ s tied to the op's first input and
first output, so that they fire when the rank's inputs are ready (its
arrival) and when the result is.  The port runs its ops eagerly, so the
dispatch point (``ops/_base.py:run_body``) calls ``begin`` as the rank
reaches the op, after any injected delay, and ``end`` once the op has
returned.  A multi-rank op on gloo returns with its result on the device
(``ops/_staging.py`` stages it through host memory and copies it back), so
the end is the op's completion; a route with no message (a self-route, an
empty one) returns with its copy queued on the device, and its bracket is
the host's part of the op.
"""

from __future__ import annotations

from typing import Optional

from . import core, journal

__all__ = ["bracket_for", "EventBracket"]


def bracket_for(rec) -> Optional["EventBracket"]:
    """The events bracket of one dispatch, or ``None`` unless the
    ``events`` tier is on (``rec`` is the dispatch's open record)."""
    if rec is None or not core.events_on():
        return None
    return EventBracket(rec)


class EventBracket:
    """Begin/end journal records of one op call."""

    __slots__ = ("rec", "rank")

    def __init__(self, rec):
        self.rec = rec
        self.rank = None

    def begin(self, call_id: str, rank: int) -> None:
        """Record this rank's arrival at the op."""
        rec = self.rec
        self.rank = int(rank)
        journal.begin(call_id, self.rank, {
            "op": rec.op,
            "comm_uid": str(rec.comm_uid),
            "axes": list(rec.comm_axes),
            "bytes": rec.bytes,
            "dtype": rec.dtype,
        })

    def end(self, call_id: str) -> None:
        """Record the op's completion, with the algorithm it took."""
        journal.end(call_id, self.rank, {"algo": self.rec.algo})
