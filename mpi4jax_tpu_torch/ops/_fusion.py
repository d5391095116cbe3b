"""Tensor fusion: adjacent small collectives packed into one.

PyTorch counterpart of ``mpi4jax_tpu/ops/_fusion.py``.  A training step
issues one allreduce per gradient; each pays a collective's fixed cost.
With ``MPI4JAX_TPU_FUSION=auto`` (or ``force``, or ``set_fusion_mode``),
an ``allreduce`` with an ``Op`` reduction or a ``bcast`` called inside a
region (``parallel/region.py``) does not run: it queues its tensor and
returns a ``LazyResult``.  The queue is issued as packed collectives at
the first of:

- a use of any deferred result (an operator, a torch function, a method,
  indexing, ``numpy()``);
- an op that does not join the queue: another op, another comm,
  reduction or root, ``flush()`` or ``barrier`` (every op flushes in
  ``_base.check_comm`` before it runs), so program order is kept;
- the end of the region, which also turns deferred outputs into tensors.

So the idiom is "issue every collective, then use the results".  A
flush packs the queue into buckets (``bucket_plan``: one dtype a bucket,
program order, closed when the next member would pass
``MPI4JAX_TPU_FUSION_BUCKET_BYTES``; ``force`` ignores the cap and sends
a lone member through the flat buffer too), concatenates each bucket's
flattened members (``torch.cat``), runs the op once on it and slices each
member's result back out (``pack_offsets``).  Autograd follows the
concatenation, the op's own Function and the slices, so a gradient
through a fused member is the unfused one.

Every reduction is elementwise, so a fused result equals the unfused one
bit for bit where the reduction's order does not depend on where an
element sits in the buffer: integers and bools, MIN and MAX, the logical
and bitwise reductions and every reduction the port folds itself
(``_base.fold``).  An f32 SUM or PROD on one ``dist.all_reduce`` adds in
the order the backend picks for each position, which may differ once
members share a buffer; there fused and unfused agree within the band
the port's SUM is held to against the JAX package (rtol 1e-5).
Callable reductions never fuse.  A deferred op's token passes through:
the packed collective is ordered by where the flush happens.  Under a
``torch.func`` transform that began inside the region an op does not
queue: its deferred result could not leave the transform
(``deferrable``).

A flush meters each bucket (``_meter_bucket``: buckets, members, packed
bytes and padding per op, comm and dtype) in the telemetry tiers, and each
packed collective goes through the dispatch point like any op; the JAX
package's analysis handoff (``take_pending_ana``) waits for the analysis
layer.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch._C import _functorch

from ..utils import config
from ..utils.tree import tree_map

# reduce_scatter never fuses: its blocks are positional, so packing would
# reroute them (its latency-hiding path is the async start/wait pair)
FUSABLE_OPS = ("allreduce", "bcast")

_UNSET = object()
_mode_override = _UNSET
# above 0 while a flush runs its packed collectives: they must not queue
_inhibit = 0


def set_fusion_mode(mode: Optional[str]) -> None:
    """Override ``MPI4JAX_TPU_FUSION`` (``None`` hands control back to the
    variable).  Either way the configuration epoch moves, so a program
    pinned before is stale (MPX129)."""
    global _mode_override
    if mode is None:
        _mode_override = _UNSET
        config.bump_config_epoch()
        return
    if mode not in config.FUSION_MODES:
        raise ValueError(
            f"fusion mode must be one of {config.FUSION_MODES}, got {mode!r}")
    _mode_override = mode
    config.bump_config_epoch()


def effective_mode() -> str:
    if _mode_override is not _UNSET:
        return _mode_override
    return config.fusion_mode()


def bucket_plan(entries, bucket_bytes: int, force: bool = False) -> List[list]:
    """Partition the queue, one ``(dtype_str, nbytes)`` a member in
    program order, into buckets: one dtype a bucket, order kept within a
    dtype, a bucket closed when the next member would pass
    ``bucket_bytes`` (an oversized member gets a bucket of its own;
    ``force`` ignores the cap).  Buckets come sorted by their first
    member, so every rank packs alike."""
    open_buckets: dict = {}
    buckets: List[list] = []
    for i, (dtype, nbytes) in enumerate(entries):
        cur = open_buckets.get(dtype)
        if cur is not None and not force and cur[1] + nbytes > bucket_bytes:
            buckets.append(cur[0])
            cur = None
        if cur is None:
            open_buckets[dtype] = ([i], nbytes)
        else:
            cur[0].append(i)
            open_buckets[dtype] = (cur[0], cur[1] + nbytes)
    buckets.extend(cur[0] for cur in open_buckets.values())
    buckets.sort(key=lambda members: members[0])
    return buckets


def pack_offsets(sizes) -> List[tuple]:
    """``[(start, end)]`` of each member in one bucket's flat buffer."""
    out, pos = [], 0
    for n in sizes:
        out.append((pos, pos + n))
        pos += n
    return out


class LazyResult:
    """A deferred collective's result.

    ``shape``, ``dtype``, ``device``, ``ndim``, ``size()``, ``numel()`` and
    ``dim()`` answer at once; every other use flushes the queue and acts on
    this member's slice of the packed result: Python's operators in both
    orders, torch functions (``__torch_function__``, so ``p - red`` and
    ``torch.cat([red, ...])`` flush), tensor methods and attributes,
    indexing and ``numpy()``.  Like the JAX package's, it is not hashable
    and ``==`` compares elementwise."""

    __slots__ = ("_shape", "_dtype", "_device", "_value", "_ctx")

    def __init__(self, shape, dtype, device, ctx):
        self._shape = torch.Size(shape)
        self._dtype = dtype
        self._device = device
        self._value = None
        self._ctx = ctx

    def _force(self):
        if self._value is None:
            flush_pending(self._ctx)
            if self._value is None:
                raise RuntimeError(
                    "deferred collective result used after its region ended "
                    "without a flush; the region's end must flush")
        self._ctx = None
        return self._value

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        args = tree_map(materialize_value, tuple(args))
        kwargs = tree_map(materialize_value, dict(kwargs or {}))
        return func(*args, **kwargs)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    @property
    def ndim(self):
        return len(self._shape)

    def dim(self):
        return len(self._shape)

    def size(self, dim=None):
        return self._shape if dim is None else self._shape[dim]

    def numel(self):
        return self._shape.numel()

    def __repr__(self):
        state = "pending" if self._value is None else "flushed"
        return f"LazyResult(shape={tuple(self._shape)}, dtype={self._dtype}, {state})"

    def __getattr__(self, name):
        # a method or attribute of the tensor is a use; a dunder probe
        # (pickle, copy) must not flush halfway through its protocol
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return getattr(self._force(), name)

    def __array__(self, *args, **kwargs):
        import numpy as np

        return np.asarray(self._force().detach().cpu(), *args, **kwargs)

    __hash__ = None

    def __len__(self):
        return len(self._force())

    def __iter__(self):
        return iter(self._force())

    def __bool__(self):
        return bool(self._force())

    def __float__(self):
        return float(self._force())

    def __int__(self):
        return int(self._force())

    def __eq__(self, o):
        return self._force() == o

    def __ne__(self, o):
        return self._force() != o

    def __lt__(self, o):
        return self._force() < o

    def __le__(self, o):
        return self._force() <= o

    def __gt__(self, o):
        return self._force() > o

    def __ge__(self, o):
        return self._force() >= o

    def __getitem__(self, idx):
        return self._force()[idx]

    def __add__(self, o):
        return self._force() + o

    def __radd__(self, o):
        return o + self._force()

    def __sub__(self, o):
        return self._force() - o

    def __rsub__(self, o):
        return o - self._force()

    def __mul__(self, o):
        return self._force() * o

    def __rmul__(self, o):
        return o * self._force()

    def __truediv__(self, o):
        return self._force() / o

    def __rtruediv__(self, o):
        return o / self._force()

    def __pow__(self, o):
        return self._force() ** o

    def __rpow__(self, o):
        return o ** self._force()

    def __matmul__(self, o):
        return self._force() @ o

    def __rmatmul__(self, o):
        return o @ self._force()

    def __and__(self, o):
        return self._force() & o

    def __rand__(self, o):
        return o & self._force()

    def __or__(self, o):
        return self._force() | o

    def __ror__(self, o):
        return o | self._force()

    def __xor__(self, o):
        return self._force() ^ o

    def __rxor__(self, o):
        return o ^ self._force()

    def __invert__(self):
        return ~self._force()

    def __neg__(self):
        return -self._force()

    def __abs__(self):
        return abs(self._force())


class _Queue:
    """The pending run of members that share ``key`` = (op, comm uid,
    reduction, root): each member's tensor and its ``LazyResult``."""

    __slots__ = ("key", "opname", "comm", "reduction", "root", "entries")

    def __init__(self, key, opname, comm, reduction, root):
        self.key = key
        self.opname = opname
        self.comm = comm
        self.reduction = reduction
        self.root = root
        self.entries: List[tuple] = []


def maybe_defer(opname: str, x, comm, token, reduction=None, root=None):
    """Queue one fusable op and return ``(LazyResult, token)``, or ``None``
    where the layer is inactive: mode ``off``, outside a region, during a
    flush, an op that does not fuse, or an abstract run of the verifier
    (``analysis/``), which records each member as its own event."""
    if _inhibit or opname not in FUSABLE_OPS or effective_mode() == "off":
        return None
    from ..analysis.hook import recording

    if recording():
        return None
    from ..parallel.region import current_context

    ctx = current_context()
    if ctx is None:
        return None
    comm = comm if comm is not None else ctx.comm
    x = materialize_value(x)
    if not deferrable(x, ctx.level):
        return None
    key = (opname, comm.uid, reduction, root)
    q = ctx.fusion_queue
    if q is not None and q.key != key:
        flush_pending(ctx)
        q = None
    if q is None:
        q = ctx.fusion_queue = _Queue(key, opname, comm, reduction, root)
    cell = LazyResult(x.shape, x.dtype, x.device, ctx)
    q.entries.append((x, cell))
    if token is None:
        from .token import Token

        token = Token()
    return cell, token


def deferrable(x, opened_at) -> bool:
    """Whether an op on ``x`` may return a deferred result (fusion,
    ``overlap()``) in a region opened at ``torch.func`` level
    ``opened_at``.  A deferred result turns into its tensor at its first
    use, at the latest at the region's end; under a transform that began
    inside the region, that end lies outside the transform, which a
    deferred value cannot leave (``vmap`` returns tensors only), so the op
    runs at once there."""
    return (not _functorch.is_functorch_wrapped_tensor(x)
            or _functorch.maybe_current_level() == opened_at)


def flush_pending(ctx) -> None:
    """Issue ``ctx``'s queue as packed collectives (nothing when empty)."""
    if ctx is None or ctx.fusion_queue is None:
        return
    q, ctx.fusion_queue = ctx.fusion_queue, None
    _flush_queue(q)


def _flush_queue(q: _Queue) -> None:
    global _inhibit
    entries = q.entries
    mode = effective_mode()
    _inhibit += 1
    try:
        if len(entries) == 1 and mode != "force":
            x, cell = entries[0]
            cell._value = _run_member(q, x)
            return
        plan = bucket_plan([(str(x.dtype), x.numel() * x.element_size())
                            for x, _ in entries],
                           config.fusion_bucket_bytes(), force=mode == "force")
        for members in plan:
            flats = [entries[i][0].reshape(-1) for i in members]
            flat = torch.cat(flats) if len(flats) > 1 else flats[0]
            _meter_bucket(q, flat, len(members))
            fused = _run_member(q, flat)
            for i, (start, end) in zip(members,
                                       pack_offsets(f.numel() for f in flats)):
                cell = entries[i][1]
                cell._value = fused[start:end].reshape(cell.shape)
    finally:
        _inhibit -= 1


def _run_member(q: _Queue, x):
    """One real collective for a bucket or a lone member, through the op
    itself."""
    if q.opname == "allreduce":
        from .allreduce import allreduce

        return allreduce(x, q.reduction, comm=q.comm)[0]
    from .bcast import bcast

    return bcast(x, q.root, comm=q.comm)[0]


def _meter_bucket(q: _Queue, flat, members: int) -> None:
    """The JAX package's bucket meters; the port packs without the ring's
    padding, so its ``padding_waste`` is 0."""
    from ..telemetry import core as _telemetry

    if _telemetry.effective_mode() == "off":
        return
    prefix = (f"fusion.{q.opname}.c{q.comm.uid}."
              f"{_telemetry.dtype_name(flat.dtype)}")
    _telemetry.meter(f"{prefix}.buckets")
    _telemetry.meter(f"{prefix}.members", members)
    _telemetry.meter(f"{prefix}.bytes_packed", flat.numel() * flat.element_size())
    _telemetry.meter(f"{prefix}.padding_waste", 0)


def materialize_value(x):
    """A deferred result's tensor (anything else as it is)."""
    return x._force() if isinstance(x, LazyResult) else x


def materialize_tree(tree):
    """Every deferred result in a nested container turned into its tensor."""
    return tree_map(materialize_value, tree)
