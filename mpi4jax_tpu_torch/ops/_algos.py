"""Payload-aware collective algorithms: the ring lowerings and the selector.

PyTorch counterpart of ``mpi4jax_tpu/ops/_algos.py``.  The butterfly ships
the whole payload every round (``2·ceil(log2 k)`` rounds, O(size·log k)
bytes a rank); the ring algorithms ship one chunk a round (``2·(k-1)``
rounds, ``~2·(k-1)/k·size`` bytes a rank).  This module holds:

- the selection, in the JAX package's rules: ``resolve_algo``,
  ``resolve_dcn_algo``, ``resolve_alltoall_algo`` and the key part
  ``algo_cache_token`` (``MPI4JAX_TPU_COLLECTIVE_ALGO`` and the three
  crossovers);
- the index formulas and update rules of the rings, plain Python over
  ints (``chunk_layout`` ... ``vdg_scatter_pairs``), with the JAX
  package's names and signatures;
- the appliers: ``apply_ring_reduce_scatter``, ``apply_ring_allgather``,
  ``apply_ring_allreduce`` (enum ``Op``s circulate one accumulator in the
  ring's rotated order, callables the lo/hi pair that keeps the ascending
  fold, ``rs_update_pair``), ``apply_pairwise_alltoall``,
  ``apply_binomial_scatter``, ``apply_vdg_bcast`` (van de Geijn) and the
  public ``reduce_scatter``'s ``apply_reduce_scatter``.

A round is one ``dist.batch_isend_irecv`` between this rank and its peers
of the round (``sendrecv.py:_exchange``), its buffers staged through
``ops/_staging.py``, so ``stats`` counts one exchange a round.  Every
tensor travels as its bytes (a ``uint8`` view), so bool, bfloat16 and
float8 payloads route on every backend.  Where JAX's ``ppermute`` gives a
rank without a pair zeros that a ``jnp.where`` then discards, the port
sends nothing; ``_where`` takes the JAX package's ``jnp.where`` with a
static condition, the chosen branch in the promoted dtype of both, so a
lowering's result has the JAX lowering's dtype (a logical reduction of
int32 through the ring is bool, as there).

The port's ``butterfly`` is what it was: one ``dist.all_gather`` and the
ascending fold (``ops/_base.py:fold``), the JAX butterfly's bits; its
modeled bytes (``algorithm_bytes_per_rank``, the telemetry link columns)
are the JAX butterfly's ``2·ceil(log2 k)·size``.

Ring lowerings need a uniform group size (the chunk count): unequal
color splits keep the butterfly.  Chunks are padded with zeros to
``k·chunk`` elements and the padding lanes are dropped after the last
reshape.  A callable on the ring must be elementwise (the payload is
chunked); ``auto`` never routes a callable to the ring, only a forced
``ring`` or ``hier`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import config

# ``auto`` never picks the ring below this group size
RING_MIN_GROUP = 4


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def algo_cache_token() -> tuple:
    """The algorithm configuration as a key part: the knob, the three
    crossovers and the topology spec; the codec only when one is on; the
    tuning layer's stamp only when a layer is active (the JAX package's
    token, so flipping any of them stales a pin, MPX129)."""
    base = (config.collective_algo(), config.ring_crossover_bytes(),
            config.dcn_crossover_bytes(), config.topology_spec(),
            config.alltoall_crossover_bytes())
    compress = config.compress_mode()
    if compress != "off":
        base = base + (("compress", compress),)
    stamp = config.tuning_stamp()
    return base if stamp is None else base + (("tuning", stamp),)


def static_group_size(comm) -> Optional[int]:
    """The comm's uniform group size, or ``None`` (unequal color-split
    groups, or an unbound comm)."""
    try:
        if comm.groups is not None:
            return comm.uniform_size()
        return comm.Get_size()
    except RuntimeError:
        return None


def resolve_algo(algo: str, payload_bytes: int, k: int, ring_ok: bool,
                 hier_ok: bool = False) -> str:
    """``"butterfly"``, ``"ring"`` or ``"hier"`` for one call.  A forced
    value wins where it is expressible: a forced ring falls back to the
    butterfly (``ring_ok=False``), a forced hier to the ``auto`` rules
    (``hier_ok=False``); never an error.  ``auto``: the hierarchy on a comm
    of several hosts, else the ring, at and above ``ring_crossover_bytes()``
    on groups of at least ``RING_MIN_GROUP``; the butterfly otherwise."""
    if algo == "hier":
        if hier_ok:
            return "hier"
        algo = "auto"  # inexpressible: fall back to the auto rules
    if not ring_ok or algo == "butterfly":
        return "butterfly"
    if algo == "ring":
        return "ring"
    if k >= RING_MIN_GROUP and payload_bytes >= config.ring_crossover_bytes():
        return "hier" if hier_ok else "ring"
    return "butterfly"


def resolve_dcn_algo(shard_bytes: int, h: int, ring_ok: bool = True) -> str:
    """The hierarchy's inter-host phase: the ring when the shard reaches
    ``dcn_crossover_bytes()`` on at least ``RING_MIN_GROUP`` hosts (and
    ``ring_ok``: callables keep the butterfly), the butterfly otherwise."""
    if (ring_ok and h >= RING_MIN_GROUP
            and shard_bytes >= config.dcn_crossover_bytes()):
        return "ring"
    return "butterfly"


def resolve_alltoall_algo(algo: str, payload_bytes: int, hier_ok: bool,
                          flat: str = "native") -> str:
    """``"hier"`` or ``flat`` for one alltoall: a forced ``hier`` where a
    plan exists, the forced flat algorithms flat, ``auto`` the hierarchy
    on a comm of several hosts at and above
    ``alltoall_crossover_bytes()``.  Pure routing either way."""
    if algo == "hier":
        return "hier" if hier_ok else flat
    if algo in ("butterfly", "ring"):
        return flat
    if hier_ok and payload_bytes >= config.alltoall_crossover_bytes():
        return "hier"
    return flat


def algorithm_bytes_per_rank(algo: str, nbytes: int, k: int,
                             preserve_order: bool = False) -> int:
    """Bytes one rank ships for an allreduce of ``nbytes`` under ``algo``
    (the JAX package's model)."""
    if k <= 1:
        return 0
    if algo == "butterfly":
        rounds = (k - 1).bit_length()  # ceil(log2 k)
        return 2 * rounds * nbytes  # fold + doubling broadcast, full payload
    chunk = -(-nbytes // k)
    pair = 2 if preserve_order else 1
    # the reduce-scatter ships the accumulator (pair or single chunk) k-1
    # times, the allgather one chunk k-1 times
    return (k - 1) * chunk * (pair + 1)


# ---------------------------------------------------------------------------
# static structure: chunk layout, ring routing, index formulas
# ---------------------------------------------------------------------------


def chunk_layout(n: int, k: int):
    """(elements per chunk, padded count ``k·chunk``) of an ``n``-element
    payload in ``k`` ring chunks."""
    chunk = -(-n // k)
    return chunk, chunk * k


def ring_pairs(groups):
    """The ring's (sender, receiver) pairs: every member sends to its
    group successor, every round."""
    return [
        (members[p], members[(p + 1) % len(members)])
        for members in groups
        if len(members) > 1
        for p in range(len(members))
    ]


def rs_send_chunk(pos, r, k):
    """Chunk index position ``pos`` sends in reduce-scatter round ``r``."""
    return (pos - r - 1) % k


def rs_recv_chunk(pos, r, k):
    """Chunk index position ``pos`` receives in reduce-scatter round ``r``
    (the predecessor's ``rs_send_chunk``)."""
    return (pos - r - 2) % k


def ag_recv_chunk(pos, r, k):
    """Chunk index received in allgather round ``r`` at position ``pos``."""
    return (pos - r - 1) % k


def rs_update_pair(where, fn, pos, c, k, lo_in, hi_in, mine):
    """Order-preserving reduce-scatter update at position ``pos`` for chunk
    ``c``: ``hi`` folds the journey's pre-wrap segment ``x_{c+1} ...
    x_{k-1}``, ``lo`` the post-wrap segment ``x_0 ... x_c``, each in
    ascending order; ``rs_finish_pair`` combines ``lo ∘ hi``, the
    ascending fold, commutativity never needed.  ``where(cond, a, b)`` is
    the caller's select; both branches are evaluated."""
    pre = (pos > c) | (c == k - 1)  # chunk k-1's journey never wraps
    lo = where(pre, lo_in, where(pos == 0, mine, fn(lo_in, mine)))
    hi = where(pre, fn(hi_in, mine), hi_in)
    return lo, hi


def rs_finish_pair(where, fn, pos, k, lo, hi):
    """The order-preserving reduce-scatter's value at ``pos``: ``lo ∘ hi``,
    except chunk ``k-1``, whose ``lo`` is still its placeholder."""
    return where(pos == k - 1, hi, fn(lo, hi))


def rotation_pairs(groups, t: int):
    """The pairs of alltoall pairwise-exchange round ``t``: position ``p``
    sends to ``(p + t) % k``."""
    return [
        (members[p], members[(p + t) % len(members)])
        for members in groups
        if len(members) > 1
        for p in range(len(members))
    ]


def a2a_send_block(pos, t, k):
    """Block index ``pos`` ships in pairwise round ``t``."""
    return (pos + t) % k


def a2a_recv_slot(pos, t, k):
    """Source position whose block reaches ``pos`` in round ``t``."""
    return (pos - t) % k


def next_pow2(k: int) -> int:
    return 1 << max(0, (k - 1).bit_length())


def vdg_widths(K: int):
    """Binomial-scatter half-widths for ``K`` virtual chunks: K/2, ..., 1."""
    w = K >> 1
    out = []
    while w >= 1:
        out.append(w)
        w >>= 1
    return out


def vdg_scatter_pairs(groups, root, w, K):
    """Pairs of one binomial-scatter round: the holder at relative
    position ``r0`` (``r0 % 2w == 0``) sends virtual chunks ``[r0+w,
    r0+2w)`` to relative position ``r0+w``; pairs whose receiver is
    outside the group carry only padding and are dropped.  Relative
    positions are group positions rotated by ``root``."""
    pairs = []
    for members in groups:
        kk = len(members)
        for r0 in range(0, K, 2 * w):
            if r0 + w < kk:
                pairs.append((members[(root + r0) % kk],
                              members[(root + r0 + w) % kk]))
    return pairs


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------


def _where(cond, a, b):
    """``jnp.where`` with a static condition: the chosen branch, in the
    promoted dtype of both."""
    dt = torch.promote_types(a.dtype, b.dtype)
    out = a if cond else b
    return out if out.dtype == dt else out.to(dt)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def exchange_round(send: Optional[torch.Tensor], dest: Optional[int],
                   recv_like: Optional[torch.Tensor],
                   source: Optional[int]) -> Optional[torch.Tensor]:
    """One round: send ``send`` to global rank ``dest`` and receive a
    tensor like ``recv_like`` from global rank ``source`` (either side may
    be ``None``), as one batch of point-to-point ops; the tensors travel
    as their bytes, viewed on the physical tensors under ``vmap``
    (``sendrecv.message_layout``).  Returns the received tensor (or
    ``None``)."""
    from ._base import exchange
    from .sendrecv import _p2p, message_layout

    def run(s, r):
        raw = _p2p(None if s is None else _bytes(s), dest,
                   None if r is None else _bytes(r), source)
        return None if raw is None else raw.view(r.dtype).reshape(r.shape)

    return exchange(run, message_layout, send, recv_like)


def _neighbours(comm, k: int):
    """(group position, successor's and predecessor's global ranks)."""
    members = comm.members()
    pos = comm.Get_rank()
    return pos, members[(pos + 1) % k], members[(pos - 1) % k]


def _pad_to(flat: torch.Tensor, total: int) -> torch.Tensor:
    n = flat.shape[0]
    if total == n:
        return flat
    return torch.cat([flat, torch.zeros(total - n, dtype=flat.dtype,
                                        device=flat.device)])


def apply_butterfly_allreduce(x, op, comm):
    """The port's butterfly: one ``dist.all_gather`` of every member's
    ``x`` (as bytes) and the ascending fold (``_base.fold``), the JAX
    butterfly's bits and dtype; any partition."""
    from ._base import STACKED, combine_fn, exchange, fold
    from .allgather import _gather_blocks

    if len(comm.members()) == 1:
        return x

    def run(v):
        rows = _gather_blocks(_bytes(v), comm)
        return rows.view(v.dtype).reshape((rows.shape[0],) + tuple(v.shape))

    out = fold(exchange(run, STACKED, x).unbind(0), combine_fn(op))
    # the butterfly's jnp.where promotes a logical result to x's dtype
    return out.to(torch.promote_types(out.dtype, x.dtype))


def apply_doubling_bcast(x, comm, root: int):
    """The port's doubling broadcast: one ``dist.broadcast`` of ``x``'s
    bytes from group position ``root`` (pure routing: the JAX doubling
    broadcast's bits)."""
    from ._base import ELEMENTWISE, exchange
    from .bcast import _broadcast

    if len(comm.members()) == 1:
        return x
    return exchange(lambda v: _broadcast(_bytes(v), root, comm).view(
        v.dtype).reshape(v.shape), ELEMENTWISE, x)


# ---------------------------------------------------------------------------
# appliers
# ---------------------------------------------------------------------------


def apply_ring_reduce_scatter(blocks, op, comm, k: int):
    """Ring reduce-scatter of ``blocks`` (``(k, *s)``) over ``comm``:
    position ``p`` receives the fold of every member's ``blocks[p]``,
    ``(*s,)``; ``k - 1`` rounds of one block (two for callables)."""
    from ._base import Op, combine_fn

    if k == 1:
        return blocks[0]
    fn = combine_fn(op)
    pos, succ, pred = _neighbours(comm, k)
    start = blocks[(pos - 1) % k]
    if not isinstance(op, Op):
        lo, hi = start, start  # lo is a placeholder until the wrap entry
        for r in range(k - 1):
            c = rs_recv_chunk(pos, r, k)
            mine = blocks[c]
            dt = torch.promote_types(lo.dtype, hi.dtype)
            pair = torch.stack([lo.to(dt), hi.to(dt)])
            recvd = exchange_round(pair, succ, pair, pred)
            lo, hi = rs_update_pair(_where, fn, pos, c, k, recvd[0],
                                    recvd[1], mine)
        return rs_finish_pair(_where, fn, pos, k, lo, hi)
    acc = start
    for r in range(k - 1):
        mine = blocks[rs_recv_chunk(pos, r, k)]
        acc = fn(exchange_round(acc, succ, acc, pred), mine)
    return acc


def apply_ring_allgather(v, comm, k: int, pos):
    """Ring allgather: ``v`` (``(*s,)``) is chunk ``pos``; every position
    receives ``(k, *s)``; ``k - 1`` rounds of one chunk."""
    out = torch.zeros((k,) + tuple(v.shape), dtype=v.dtype, device=v.device)
    out[pos] = v
    if k == 1:
        return out
    _, succ, pred = _neighbours(comm, k)
    cur = v
    for r in range(k - 1):
        cur = exchange_round(cur, succ, cur, pred)
        out[ag_recv_chunk(pos, r, k)] = cur
    return out


def apply_ring_allreduce(x, op, comm, k=None):
    """Ring reduce-scatter and ring allgather: ``2·(k-1)`` chunk rounds,
    all 10 ``Op``s and elementwise associative callables (ascending
    fold).  Needs a uniform group size."""
    if k is None:
        k = comm.Get_size()
    if k == 1:
        return x
    shape, n = x.shape, x.numel()
    chunk, padded = chunk_layout(n, k)
    blocks = _pad_to(x.reshape(-1), padded).reshape(k, chunk)
    mine = apply_ring_reduce_scatter(blocks, op, comm, k)
    full = apply_ring_allgather(mine, comm, k, comm.Get_rank())
    return full.reshape(-1)[:n].reshape(shape)


def apply_pairwise_alltoall(blocks, comm, k: int):
    """Pairwise-exchange alltoall of ``blocks`` (``(k, *s)``, block ``i``
    to position ``i``): ``out[q]`` is position ``q``'s block to this
    rank; ``k - 1`` rounds, round ``t`` a rotation by ``t``."""
    if k == 1:
        return blocks
    members = comm.members()
    pos = comm.Get_rank()
    out = torch.zeros_like(blocks)
    out[pos] = blocks[pos]  # own block
    for t in range(1, k):
        send = blocks[a2a_send_block(pos, t, k)]
        recvd = exchange_round(send, members[(pos + t) % k], send,
                               members[(pos - t) % k])
        out[a2a_recv_slot(pos, t, k)] = recvd
    return out


def apply_binomial_scatter(buf, members, root: int, relpos: int, K: int):
    """The binomial-halving scatter shared by ``apply_vdg_bcast`` and the
    hierarchical broadcast: ``buf`` holds ``K`` virtual chunk rows by
    absolute index, ``members`` this rank's group (global ranks, group
    order), ``relpos`` this rank's root-rotated position.  Each round the
    holder at ``r0`` ships rows ``[r0+w, r0+2w)`` to ``r0+w``, which writes
    them at its own ``relpos``."""
    kk = len(members)
    for w in vdg_widths(K):
        pairs = vdg_scatter_pairs([tuple(range(kk))], root, w, K)
        if not pairs:
            continue
        me = (root + relpos) % kk
        dest = next((d for s, d in pairs if s == me), None)
        src = next((s for s, d in pairs if d == me), None)
        if dest is None and src is None:
            continue
        slab = buf[relpos + w:relpos + 2 * w] if dest is not None else None
        like = buf[relpos:relpos + w] if src is not None else None
        recvd = exchange_round(
            slab, None if dest is None else members[dest],
            like, None if src is None else members[src])
        if (relpos % (2 * w)) == w:
            buf = buf.clone()
            buf[relpos:relpos + w] = recvd
    return buf


def apply_vdg_bcast(x, comm, root: int, k=None):
    """Broadcast from ``root`` by binomial-halving scatter and ring
    allgather (van de Geijn): ~2·size bytes a rank against the doubling
    broadcast's size·ceil(log2 k).  The chunk count is padded to a power
    of two; the padding is dropped.  Needs a uniform group size."""
    from ._base import check_root

    if k is None:
        k = comm.Get_size()
    check_root(root, comm.min_size(), "apply_vdg_bcast")
    if k == 1:
        return x
    pos = comm.Get_rank()
    relpos = (pos - root) % k
    shape, n = x.shape, x.numel()
    chunk, _ = chunk_layout(n, k)
    K = next_pow2(k)
    buf = _pad_to(x.reshape(-1), K * chunk).reshape(K, chunk)
    buf = apply_binomial_scatter(buf, comm.members(), root, relpos, K)
    mine = buf[relpos]  # this rank's real chunk (relpos < k)
    full = apply_ring_allgather(mine, comm, k, relpos)
    return full.reshape(-1)[:n].reshape(shape)


def select_reduce_scatter(x, op, comm):
    """The public ``reduce_scatter``'s lowering for ``x`` (``(k, *s)``):
    ``("native", None)`` for SUM on a whole single-axis comm under
    ``auto``, else the selector's pick and the plan, annotated
    (``_hierarchy.annotate_selection``).  Runs in abstract runs too."""
    from ..analysis.hook import dtype_name
    from . import _hierarchy
    from ._base import SUM, Op, annotate_native

    k = comm.Get_size()
    algo = config.collective_algo()
    if (algo == "auto" and op is SUM and comm.groups is None
            and len(comm.axes) == 1):
        annotate_native()
        return "native", None
    plan = _hierarchy.hier_plan(comm)
    nbytes = x.numel() * x.element_size()
    algo = resolve_algo(algo, nbytes, k, ring_ok=True,
                        hier_ok=plan is not None)
    _hierarchy.annotate_selection("reduce_scatter", algo, nbytes, k, plan,
                                  comm, preserve=not isinstance(op, Op),
                                  op=op, dtype=dtype_name(x.dtype))
    return algo, plan


def apply_reduce_scatter(x, op, comm, algo, plan):
    """Run the ``reduce_scatter`` lowering ``select_reduce_scatter``
    picked (``"ring"`` or ``"hier"``; the port's own route, the
    ``alltoall`` of the blocks and the ascending fold, serves ``native``
    and the butterfly, the JAX butterfly-then-select's bits)."""
    from . import _hierarchy

    if algo == "hier":
        return _hierarchy.apply_hier_reduce_scatter(x, op, comm, plan)
    return apply_ring_reduce_scatter(x, op, comm, comm.Get_size())
