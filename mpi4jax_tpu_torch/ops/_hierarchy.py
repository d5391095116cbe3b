"""Topology-aware collectives: the two-level intra-host/inter-host lowerings.

PyTorch counterpart of ``mpi4jax_tpu/ops/_hierarchy.py``.  A flat ring
over ``h`` hosts of ``r`` ranks gates every round on the slowest link; the
two-level decomposition keyed on the host topology
(``parallel/topology.py``) keeps most rounds inside a host:

- ``apply_hier_allreduce``: intra-host ring reduce-scatter (each rank
  ends with a ``1/r`` shard of its host's partial), inter-host allreduce
  of the shards among the ``r`` position groups (ring or butterfly by
  shard bytes against ``MPI4JAX_TPU_DCN_CROSSOVER_BYTES``), intra-host
  ring allgather;
- ``apply_hier_reduce_scatter``: the same without the allgather;
- ``apply_hier_bcast``: binomial-halving scatter inside the root's host,
  inter-host broadcast of each chunk from the root's host (doubling or
  van de Geijn), intra-host ring allgather;
- ``apply_hier_alltoall``: intra-host transpose, inter-host exchange of
  host-aggregated blocks (``1/r`` the inter-host messages of flat), a
  local de-interleave.

Fold order: each host block folds in ascending group order, then the
per-host partials in ascending host order.  A plan needs every group's
host blocks to be contiguous ascending runs of the group order, so this
is the flat ascending fold's operand sequence: associativity alone makes
hierarchical == flat.

A plan exists only where every group of the comm splits into ``h >= 2``
contiguous host blocks of one size ``r``, the same for every group.
Otherwise (``3,5``, round-robin placement, one host, no topology)
``hier_plan(comm)`` is ``None`` and the flat algorithms run: never an
error.  ``HierPlan.intra`` and ``.inter`` are ``GroupComm``s derived from
the comm (``parallel/comm.py``): they take no uid, and their process
groups are made at the plan's first real use (``HierPlan.ready``, each
comm's in ``ensure_groups``'s sorted order), so that a plan that one
rank built again after its memo dropped it and another found in its memo
changes neither the uids nor the order of group creation.  An abstract
run of the verifier builds plans without making a group.

The plan geometry and the per-link-class byte models are plain Python
over ints, the JAX package's; the cost model (``analysis/costmodel.py``)
imports them from here.  ``annotate_selection`` writes the op's
selection onto its verifier event (``algo``, ``hosts``, ``hier``,
``codec``) and its telemetry record (``intra_bytes``, ``inter_bytes``,
``wire_inter_bytes``).  The inter-host leg is the only place a codec
(``MPI4JAX_TPU_COMPRESS``) shrinks what travels (``ops/_compress.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

import torch

from . import _algos
from ._compress import dcn_codec as _dcn_codec

__all__ = [
    "host_blocks",
    "hier_split",
    "hier_plan",
    "comm_hosts",
    "hier_link_bytes",
    "flat_link_bytes",
    "alltoall_dcn_messages",
    "dcn_leg_bytes",
    "selected_codec",
    "annotate_selection",
    "apply_hier_allreduce",
    "apply_hier_reduce_scatter",
    "apply_hier_bcast",
    "apply_hier_alltoall",
]


# ---------------------------------------------------------------------------
# plan geometry
# ---------------------------------------------------------------------------


def host_blocks(members, host_of_rank) -> Optional[List[List[int]]]:
    """``members`` (one group, in group order) as runs of same-host ranks;
    ``None`` when a host's members are not contiguous (round-robin
    placement), which would permute the fold's operands."""
    blocks: List[List[int]] = []
    seen = set()
    cur = None
    for m in members:
        h = host_of_rank[m]
        if h != cur:
            if h in seen:
                return None  # host reappears: non-contiguous
            seen.add(h)
            blocks.append([])
            cur = h
        blocks[-1].append(m)
    return blocks


def hier_split(groups, host_of_rank):
    """``(intra_groups, inter_groups, h, r)`` of ``groups`` under
    ``host_of_rank``, or ``None`` where one program cannot express it:
    every group splits into ``h >= 2`` contiguous host blocks of one size
    ``r``, the same for every group; ``intra_groups`` are the blocks,
    ``inter_groups`` the ranks at intra position ``j`` of every block of a
    group (``r`` a group, ``h`` members each)."""
    intra_groups: List[tuple] = []
    inter_groups: List[tuple] = []
    h = r = None
    for members in groups:
        blocks = host_blocks(members, host_of_rank)
        if blocks is None:
            return None
        sizes = {len(b) for b in blocks}
        if len(sizes) != 1:
            return None  # non-uniform ranks-per-host
        gh, gr = len(blocks), sizes.pop()
        if h is None:
            h, r = gh, gr
        elif (gh, gr) != (h, r):
            return None  # per-group hierarchies: inexpressible
        intra_groups.extend(tuple(b) for b in blocks)
        for j in range(gr):
            inter_groups.append(tuple(b[j] for b in blocks))
    if h is None or h < 2:
        return None  # single-host (or empty): nothing to hierarchize
    return tuple(intra_groups), tuple(inter_groups), h, r


# ---------------------------------------------------------------------------
# per-link-class byte models
# ---------------------------------------------------------------------------


def hier_link_bytes(kind: str, nbytes: int, h: int, r: int,
                    preserve: bool = False) -> Tuple[int, int]:
    """Modeled per-rank bytes ``(intra_host, inter_host)`` of one
    hierarchical ``kind`` of ``nbytes`` over ``h`` hosts of ``r`` ranks,
    round for round with the lowerings below (the inter algorithm
    resolved as the lowering resolves it); ``pair`` is 2 for
    order-preserving callables (the lo/hi accumulator), 1 for ``Op``s."""
    pair = 2 if preserve else 1
    chunk = -(-nbytes // r)
    if kind == "alltoall":
        # intra transpose: (r-1) blocks of size/r; inter: (h-1)
        # host-aggregated blocks of size/h (the final scatter is local)
        intra = (r - 1) * chunk
        inter = (h - 1) * (-(-nbytes // h))
        return intra, inter
    if kind == "allreduce":
        intra = (r - 1) * chunk * (pair + 1)
        dcn = _algos.resolve_dcn_algo(chunk, h, ring_ok=not preserve)
        inter = _algos.algorithm_bytes_per_rank(dcn, chunk, h, preserve)
        return intra, inter
    if kind == "reduce_scatter":
        super_b = chunk  # one position super-block = size/r bytes
        intra = (r - 1) * super_b * pair
        block = -(-super_b // h)
        if _algos.resolve_dcn_algo(super_b, h) == "ring":
            inter = (h - 1) * block * pair
        else:  # butterfly allreduce + own-block select
            inter = 2 * (h - 1).bit_length() * super_b if h > 1 else 0
        return intra, inter
    if kind == "bcast":
        intra = nbytes + (r - 1) * chunk  # halving scatter + ring allgather
        if _algos.resolve_dcn_algo(chunk, h) == "ring":
            inter = 2 * chunk  # van de Geijn: scatter + allgather
        else:
            inter = (h - 1).bit_length() * chunk  # doubling rounds
        return intra, inter
    raise ValueError(f"unknown hierarchical collective kind {kind!r}")


def flat_link_bytes(kind: str, algo: str, nbytes: int, k: int,
                    h: Optional[int],
                    preserve: bool = False) -> Tuple[int, int]:
    """Link-class attribution of a flat algorithm, per op kind: allreduce
    butterfly ``2·ceil(log2 k)·size``, ring ``(k-1)·chunk·(pair+1)``;
    bcast doubling ``ceil(log2 k)·size``, van de Geijn ``~2·size``;
    reduce_scatter butterfly ``2·ceil(log2 k)·size``, ring
    ``(k-1)·chunk·pair``; alltoall ``(k-1)`` blocks of ``size/k``.  All
    of it on the inter-host class when the comm spans ``h > 1`` hosts,
    else intra; ``native`` (and no topology) is the payload on intra."""
    pair = 2 if preserve else 1
    rounds = (k - 1).bit_length() if k > 1 else 0  # ceil(log2 k)
    chunk = -(-nbytes // k) if k else nbytes
    if kind == "alltoall":
        total = (k - 1) * chunk
        if h is not None and h > 1:
            return 0, total
        return total, 0
    if algo == "butterfly":
        if kind == "bcast":
            total = rounds * nbytes
        else:  # allreduce; reduce_scatter = allreduce + own-block select
            total = 2 * rounds * nbytes
    elif algo == "ring":
        if kind == "bcast":  # van de Geijn: scatter + ring allgather
            total = nbytes + (k - 1) * chunk
        elif kind == "reduce_scatter":
            total = (k - 1) * chunk * pair
        else:  # allreduce: reduce-scatter + allgather
            total = (k - 1) * chunk * (pair + 1)
    else:
        return nbytes, 0
    if h is not None and h > 1:
        return 0, total
    return total, 0


def alltoall_dcn_messages(h: int, r: int) -> Tuple[int, int]:
    """Inter-host message counts ``(flat, hier)`` of one alltoall over
    ``h`` hosts of ``r`` ranks: ``r²·h·(h-1)`` against ``r·h·(h-1)``,
    ``1/r`` as many at ``r`` times the size."""
    flat = r * r * h * (h - 1)
    hier = r * h * (h - 1)
    return flat, hier


# ---------------------------------------------------------------------------
# the plan: derived comms, memoized per (comm, topology)
# ---------------------------------------------------------------------------


class HierPlan:
    """One comm's two-level decomposition: the intra-host and inter-host
    derived comms and the geometry."""

    __slots__ = ("intra", "inter", "h", "r", "_ready")

    def __init__(self, intra, inter, h: int, r: int):
        self.intra = intra
        self.inter = inter
        self.h = h
        self.r = r
        self._ready = False

    def ready(self) -> "HierPlan":
        """Make the process groups of both comms where they have none yet
        (``GroupComm.make_groups``, collective where it creates one); every
        applier calls it before its first round."""
        if not self._ready:
            self.intra.make_groups()
            self.inter.make_groups()
            self._ready = True
        return self

    def __repr__(self):
        return f"HierPlan(h={self.h}, r={self.r})"


_plan_memo: "OrderedDict" = OrderedDict()
_PLAN_MEMO_MAX = 64
_NO_PLAN = object()


def hier_plan(comm) -> Optional[HierPlan]:
    """The two-level plan of ``comm``, or ``None`` where it is not
    expressible; memoized (LRU, 64) per (comm, grid, axes, topology,
    groups)."""
    from ..parallel.topology import derive_world_topology

    topo = derive_world_topology(comm)
    if topo is None or topo.num_hosts < 2:
        return None
    groups = comm.groups
    if groups is None:
        try:
            world = comm.world_size()
        except RuntimeError:
            return None
        groups = (tuple(range(world)),)
    key = (comm.uid, comm.mesh, comm.axes, topo.fingerprint(), groups)
    cached = _plan_memo.get(key)
    if cached is not None:
        _plan_memo.move_to_end(key)
        return None if cached is _NO_PLAN else cached
    split = hier_split(groups, topo.host_of_rank)
    if split is None:
        plan = None
    else:
        from ..parallel.comm import GroupComm

        intra_groups, inter_groups, h, r = split
        plan = HierPlan(GroupComm(comm, intra_groups, derived="intra"),
                        GroupComm(comm, inter_groups, derived="inter"), h, r)
    _plan_memo[key] = _NO_PLAN if plan is None else plan
    if len(_plan_memo) > _PLAN_MEMO_MAX:
        _plan_memo.popitem(last=False)
    return plan


_hosts_memo: "OrderedDict" = OrderedDict()
_HOSTS_MEMO_MAX = 64


def comm_hosts(comm) -> Optional[int]:
    """How many hosts ``comm``'s widest group spans (``None`` without a
    topology): the multi-host signal of the telemetry link classes, which
    exists where no plan does (non-uniform partitions)."""
    from ..parallel.topology import derive_world_topology

    topo = derive_world_topology(comm)
    if topo is None:
        return None
    groups = comm.groups
    if groups is None:
        return topo.num_hosts
    key = (comm.uid, topo.fingerprint(), groups)
    cached = _hosts_memo.get(key)
    if cached is not None:
        _hosts_memo.move_to_end(key)
        return cached
    hosts = max(
        len({topo.host_of_rank[m] for m in members}) for members in groups
    )
    _hosts_memo[key] = hosts
    if len(_hosts_memo) > _HOSTS_MEMO_MAX:
        _hosts_memo.popitem(last=False)
    return hosts


def dcn_leg_bytes(kind: str, nbytes: int, r: int) -> int:
    """The payload the inter-host phase of a hierarchical ``kind`` sees
    (the codec's bucket): the whole payload for the alltoall, one ``1/r``
    chunk for the reduction family."""
    return nbytes if kind == "alltoall" else -(-nbytes // r)


def selected_codec(kind: str, nbytes: int, plan: Optional[HierPlan],
                   preserve: bool = False, op=None,
                   dtype: Optional[str] = None) -> Optional[str]:
    """The codec the hierarchy's inter-host leg applies (``None``: exact):
    hier only, float32 only, never for order-preserving callables; fp8
    degrades to bf16 for a reduction other than SUM
    (``_compress._effective``)."""
    if plan is None or preserve or dtype != "float32":
        return None
    from . import _codec

    codec = _codec.codec_for(dcn_leg_bytes(kind, nbytes, plan.r), "float32")
    if codec == "fp8" and op is not None and \
            kind in ("allreduce", "reduce_scatter"):
        from ._base import SUM

        if op != SUM:
            codec = "bf16"
    return codec


def annotate_selection(kind: str, algo: str, nbytes: int, k: int,
                       plan: Optional[HierPlan], comm,
                       preserve: bool = False, op=None,
                       dtype: Optional[str] = None) -> None:
    """Annotate one dispatch: the algorithm (verifier and telemetry), the
    host span (MPX113; on the event only where a plan exists), the plan
    it lowered with (MPX125), the modeled bytes by link class, and with a
    codec on the inter-host leg the codec and the compressed inter-host
    bytes (MPX138)."""
    from ..analysis.hook import annotate as a_annotate
    from ..telemetry.core import annotate as t_annotate

    hosts = plan.h if plan is not None else comm_hosts(comm)
    if algo == "hier":
        link = hier_link_bytes(kind, nbytes, plan.h, plan.r, preserve)
    else:
        link = flat_link_bytes(kind, algo, nbytes, k, hosts, preserve)
    codec = None
    wire = link
    if algo == "hier":
        codec = selected_codec(kind, nbytes, plan, preserve, op, dtype)
        if codec is not None:
            from . import _codec

            wire = (link[0], _codec.wire_bytes(link[1], codec))
    a_annotate(algo=algo, hosts=plan.h if plan is not None else None,
               hier=(plan.h, plan.r) if (plan is not None
                                         and algo == "hier") else None,
               codec=codec)
    t_annotate(algo=algo, link_bytes=link, wire_bytes=wire)


# ---------------------------------------------------------------------------
# appliers
# ---------------------------------------------------------------------------


def apply_hier_allreduce(x, op, comm, plan: HierPlan):
    """Two-level allreduce: intra-host ring reduce-scatter, inter-host
    allreduce of each rank's shard, intra-host ring allgather.  All 10
    ``Op``s and elementwise associative callables, the flat ascending
    fold's bits."""
    plan.ready()
    r = plan.r
    if r == 1:
        # one rank a host: the inter phase is the whole collective
        return _inter_allreduce(x, op, plan, x.numel() * x.element_size())
    shape, n = x.shape, x.numel()
    chunk, padded = _algos.chunk_layout(n, r)
    blocks = _algos._pad_to(x.reshape(-1), padded).reshape(r, chunk)
    mine = _algos.apply_ring_reduce_scatter(blocks, op, plan.intra, r)
    reduced = _inter_allreduce(mine, op, plan, chunk * x.element_size())
    pos = plan.intra.Get_rank()
    full = _algos.apply_ring_allgather(reduced, plan.intra, r, pos)
    return full.reshape(-1)[:n].reshape(shape)


def _inter_allreduce(v, op, plan: HierPlan, shard_bytes: int):
    """The inter-host phase: allreduce ``v`` over the inter comm, ring or
    butterfly by shard bytes (callables keep the butterfly)."""
    from ._base import Op

    if plan.h == 1:
        return v
    codec = _dcn_codec(v, shard_bytes, op)
    if codec is not None:
        from . import _compress

        return _compress.inter_allreduce(v, op, plan, shard_bytes, codec)
    ring_ok = isinstance(op, Op)
    if _algos.resolve_dcn_algo(shard_bytes, plan.h, ring_ok) == "ring":
        return _algos.apply_ring_allreduce(v, op, plan.inter, plan.h)
    return _algos.apply_butterfly_allreduce(v, op, plan.inter)


def apply_hier_reduce_scatter(xl, op, comm, plan: HierPlan):
    """Two-level reduce-scatter of ``xl`` (``(k, *s)``, block ``i`` to
    position ``i``): intra-host ring reduce-scatter of the ``r`` position
    super-blocks, then inter-host reduce-scatter of the per-host
    partials; ``(*s,)``.  Blocks are never re-chunked, so block-wise
    callables stay valid (they see ``(h, *s)`` stacks in the intra
    phase)."""
    plan.ready()
    r, h = plan.r, plan.h
    if r == 1:
        return _inter_reduce_scatter(xl, op, plan)
    s = tuple(xl.shape[1:])
    y = torch.movedim(xl.reshape((h, r) + s), 1, 0)  # y[j, b] = block b·r+j
    partial = _algos.apply_ring_reduce_scatter(y, op, plan.intra, r)
    return _inter_reduce_scatter(partial, op, plan)


def _inter_reduce_scatter(blocks, op, plan: HierPlan):
    """The inter-host phase of the reduce-scatter: ``blocks`` (``(h,
    *s)``) are this rank's per-host partials; host ``b``'s rank receives
    the ascending-host fold of every host's partial ``b``."""
    h = plan.h
    if h == 1:
        return blocks[0]
    nbytes = blocks.numel() * blocks.element_size()
    codec = _dcn_codec(blocks, nbytes, op)
    if codec is not None:
        from . import _compress

        return _compress.inter_reduce_scatter(blocks, op, plan, codec)
    if _algos.resolve_dcn_algo(nbytes, h) == "ring":
        return _algos.apply_ring_reduce_scatter(blocks, op, plan.inter, h)
    full = _algos.apply_butterfly_allreduce(blocks, op, plan.inter)
    return full[plan.inter.Get_rank()]


def apply_hier_bcast(x, comm, root: int, plan: HierPlan):
    """Two-level broadcast from group position ``root`` (host block and
    intra position ``divmod(root, r)``): binomial-halving scatter of ``r``
    chunks inside the root's host block, inter-host broadcast of each
    chunk from the root's host, intra-host ring allgather."""
    plan.ready()
    r = plan.r
    itemsize = x.element_size()
    if r == 1:
        return _inter_bcast(x, plan, root, x.numel() * itemsize)
    b0, j0 = divmod(root, r)
    shape, n = x.shape, x.numel()
    chunk, _ = _algos.chunk_layout(n, r)
    R = _algos.next_pow2(r)
    pos = plan.intra.Get_rank()
    relpos = (pos - j0) % r
    buf = _algos._pad_to(x.reshape(-1), R * chunk).reshape(R, chunk)
    buf = _algos.apply_binomial_scatter(buf, plan.intra.members(), j0,
                                        relpos, R)
    mine = buf[relpos]  # this rank's chunk (relpos < r)
    mine = _inter_bcast(mine, plan, b0, chunk * itemsize)
    full = _algos.apply_ring_allgather(mine, plan.intra, r, relpos)
    return full.reshape(-1)[:n].reshape(shape)


def apply_hier_alltoall(xl, comm, plan: HierPlan):
    """Two-level alltoall of ``xl`` (``(k, *s)``, block ``i`` to position
    ``i = b·r + j``): an intra-host pairwise transpose leaves rank
    ``(b, j)`` with its host's whole traffic for position ``j`` of every
    host; the inter-host exchange over the position-``j`` group ships one
    aggregated block a host; the result is already in ascending group
    order.  Pure routing: flat's bits."""
    plan.ready()
    h, r = plan.h, plan.r
    s = tuple(xl.shape[1:])
    nbytes = xl.numel() * xl.element_size()
    codec = _dcn_codec(xl, nbytes)
    if r == 1:
        # one rank a host: the inter exchange is the whole alltoall
        if codec is not None:
            from . import _compress

            return _compress.inter_alltoall(xl, plan, h, codec)
        return _algos.apply_pairwise_alltoall(xl, plan.inter, h)
    y = torch.movedim(xl.reshape((h, r) + s), 1, 0)  # y[j, b'] = (b'·r + j)
    a = _algos.apply_pairwise_alltoall(y.contiguous(), plan.intra, r)
    # a[i, b'] = host-mate i's block addressed to (b', my intra position)
    z = torch.movedim(a, 1, 0).contiguous()  # z[b', i]
    if codec is not None:
        from . import _compress

        w = _compress.inter_alltoall(z, plan, h, codec)
    else:
        w = _algos.apply_pairwise_alltoall(z, plan.inter, h)
    # w[b'', i] = the block rank b''·r + i addressed to me
    return w.reshape((h * r,) + s)


def _inter_bcast(v, plan: HierPlan, b0: int, nbytes: int):
    """The inter-host phase of the broadcast: every inter group broadcasts
    from position ``b0`` (the root's host)."""
    if plan.h == 1:
        return v
    codec = _dcn_codec(v, nbytes)
    if codec is not None:
        from . import _compress

        return _compress.inter_bcast(v, plan, b0, codec)
    if _algos.resolve_dcn_algo(nbytes, plan.h) == "ring":
        return _algos.apply_vdg_bcast(v, plan.inter, b0, plan.h)
    return _algos.apply_doubling_bcast(v, plan.inter, b0)
