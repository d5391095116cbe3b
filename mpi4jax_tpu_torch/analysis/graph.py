"""The collective graph: what the verifier sees of a program.

The port's own copy of ``mpi4jax_tpu/analysis/graph.py``.  One
:class:`CollectiveEvent` is recorded per op at the port's dispatch point
(``ops/_base.py:run_body``, while a recorder collects): op kind,
communicator identity, static structure (root, routing pairs, tag),
payload size and dtype, the token edges.  A :class:`CollectiveGraph` is
the ordered stream of one abstract run plus the configuration snapshot
the checkers need.

Token and buffer edges are recorded as opaque ids (``id()`` of the
carrier; the recorder pins the carriers so ids cannot be reused within
one recording).  Checkers treat ids purely as equality handles.

Pure Python, so hand-built graphs drive the checkers in the tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class CollectiveEvent:
    """One collective as seen at dispatch.  Mutable: ops annotate fields
    that only become known inside their body (routing pairs, match depth,
    selected algorithm) via ``analysis.hook.annotate``."""

    index: int
    op: str
    comm_uid: int = 0
    comm_axes: Tuple[str, ...] = ()
    comm_size: Optional[int] = None     # static group size, if it has one
    min_size: Optional[int] = None      # smallest group (root bound)
    split: bool = False                 # color-split comm?
    payload_bytes: int = 0
    dtype: str = ""
    shape: Tuple[int, ...] = ()
    root: Optional[int] = None
    pairs: Optional[Tuple[Tuple[int, int], ...]] = None
    tag: Optional[int] = None
    reduction: Optional[str] = None
    algo: Optional[str] = None    # "native" | "butterfly" | "ring" | "hier"
    hosts: Optional[int] = None   # hosts the comm's widest group spans
    token_in: Optional[int] = None
    token_out: Optional[int] = None
    eager: bool = False
    span: Optional[int] = None          # async start/wait pairing handle id
    # megastep loop scope (parallel/megastep.py): the loop id of the
    # device-resident fori_loop body this op was traced inside, and its
    # trip count.  None outside any megastep.  MPX130 errors on async
    # spans straddling a loop boundary; MPX128 skips loop-body events
    # (the body traces ONCE — it is not an unrolled Python loop).
    loop: Optional[int] = None
    unroll: Optional[int] = None
    fused_members: Optional[int] = None  # member ops packed into this op
    fused_bytes: Optional[int] = None   # flat-buffer payload bytes
    # per-member (dtype, nelems) composition of a fused flat buffer — the
    # cross-rank matcher compares it across ranks (MPX124)
    fused_layout: Optional[Tuple] = None
    # (hosts, ranks_per_host) of the two-level plan this op lowered with
    # (ops/_hierarchy.annotate_selection), compared across ranks (MPX125)
    hier: Optional[Tuple[int, int]] = None
    # DCN-leg wire codec the hierarchy applied ("bf16" | "fp8"), None on
    # exact lowerings (docs/compression.md) — prices the inter-host leg
    # at wire bytes in the cost model and gates the MPX138 advisory
    codec: Optional[str] = None
    # communication epoch the comm was built in (parallel/comm.py stamp;
    # resilience/elastic.py revocation) — compared against the CURRENT
    # epoch in graph.meta by the MPX126 checker
    epoch: Optional[int] = None
    # True when the comm's world executed a planned drain and this
    # collective was issued AFTER the leave boundary (resilience/
    # elastic.py drained-comm registry) — flagged MPX127.  A comm merely
    # *scheduled* to drain (boundary not yet reached) records False:
    # collectives remain legal through the boundary.
    drained: bool = False
    # buffer identities (``id()`` of the traced array carriers, pinned by
    # the recorder like the token carriers) of this op's array inputs —
    # fusion flushes overwrite them with the MEMBER buffers of the packed
    # flat buffer, so a LazyResult aliasing a bucket member stays
    # traceable.  The dataflow hazard checkers (analysis/hazards.py)
    # intersect these with the donation records in
    # ``CollectiveGraph.meta["donations"]`` (MPX139/MPX140); they are
    # equality handles only and never rendered.
    buffers: Tuple[int, ...] = ()
    # static member groups (global ranks, group order) of this op's comm
    # when derivable — comm.groups on a split, or the rank-concretization
    # scope's sub-axes partition during a per-rank schedule trace.  The
    # cross-rank schedule builder reads participants from here.
    groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    extra: Dict = field(default_factory=dict)

    def where(self) -> str:
        return f"{self.op}#{self.index}"


@dataclass
class CollectiveGraph:
    """Ordered event stream of one trace + the config snapshot."""

    events: List[CollectiveEvent] = field(default_factory=list)
    # {"collective_algo": ..., "ring_crossover_bytes": ...}; when the
    # recording saw pinned calls that donate buffers (aot/pinning.py),
    # also "donations": tuple of (event-stream position, frozenset of
    # donated buffer ids, human-readable call site) — present only when
    # nonempty so pre-hazard snapshots stay byte-identical
    meta: Dict = field(default_factory=dict)

    def by_channel(self) -> Dict[Tuple[int, Optional[int]], List[CollectiveEvent]]:
        """Point-to-point events grouped by (comm_uid, tag) channel, in
        stream order — the FIFO matching domains."""
        out: Dict[Tuple[int, Optional[int]], List[CollectiveEvent]] = {}
        for e in self.events:
            if e.op in ("send", "recv"):
                out.setdefault((e.comm_uid, e.tag), []).append(e)
        return out

    def by_comm(self) -> Dict[int, List[CollectiveEvent]]:
        out: Dict[int, List[CollectiveEvent]] = {}
        for e in self.events:
            out.setdefault(e.comm_uid, []).append(e)
        return out
