"""Shared pieces of the ops: the reductions, MPX-tagged errors, buffer checks.

PyTorch counterpart of ``mpi4jax_tpu/ops/_base.py`` (``Op``, the local
combine of each reduction, ``combine_fn``) and of the
part of ``mpi4jax_tpu/analysis/report.py`` that the ops raise.  The codes
keep the JAX package's meaning, so a message greps the same:

- MPX101, unmatched send: a send still queued at ``flush()``;
- MPX102, recv without matching send: a recv found no queued send on its
  (comm, tag);
- MPX103, bare-int routing;
- MPX105, root out of range;
- MPX106, send/recv type-signature mismatch;
- MPX112, an async start waited twice, or never waited in its region;
- MPX129, a pinned program called after its world moved
  (``aot/invalidation.py``);
- MPX130, an async span that straddles a megastep loop boundary
  (``ops/_async.py``).

``fold`` combines the blocks of every rank in ascending group-rank order
with the association of the JAX package's doubling butterfly
(``apply_butterfly_allreduce``: after the round of offset ``w``, position
``p`` holds the fold of positions ``[p, p + 2w)``), so that a callable that
is associative but not commutative gives the same bits on every rank, and
the JAX package's bits.
"""

from __future__ import annotations

import enum
from typing import Callable, Union

import torch

from ..parallel.region import current_context
from ._fusion import flush_pending

CODES = frozenset({"MPX101", "MPX102", "MPX103", "MPX105", "MPX106", "MPX112",
                   "MPX129", "MPX130"})


class Op(enum.Enum):
    """Reduction operations, the members of the JAX package's ``Op``.  A
    Python callable ``f(a, b)`` is accepted wherever an ``Op`` is; it must
    be associative (MPI's contract), not commutative."""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"
    LAND = "land"
    LOR = "lor"
    LXOR = "lxor"
    BAND = "band"
    BOR = "bor"
    BXOR = "bxor"


SUM = Op.SUM
PROD = Op.PROD
MIN = Op.MIN
MAX = Op.MAX
LAND = Op.LAND
LOR = Op.LOR
LXOR = Op.LXOR
BAND = Op.BAND
BOR = Op.BOR
BXOR = Op.BXOR

OpLike = Union[Op, Callable]

# the local combine of each reduction: the logical ones give bool, the
# bitwise ones keep the input dtype (jnp.logical_* / jnp.bitwise_*)
_LOCAL_COMBINE = {
    Op.SUM: torch.add,
    Op.PROD: torch.mul,
    Op.MIN: torch.minimum,
    Op.MAX: torch.maximum,
    Op.LAND: torch.logical_and,
    Op.LOR: torch.logical_or,
    Op.LXOR: torch.logical_xor,
    Op.BAND: torch.bitwise_and,
    Op.BOR: torch.bitwise_or,
    Op.BXOR: torch.bitwise_xor,
}


def combine_fn(op: OpLike) -> Callable:
    """The binary function that combines two ranks' values under ``op``."""
    if isinstance(op, Op):
        return _LOCAL_COMBINE[op]
    if callable(op):
        return op
    raise TypeError(
        f"op must be an mpi4jax_tpu_torch.Op or a binary callable, got {op!r}"
    )


def fold(blocks, fn: Callable):
    """Combine ``blocks`` (a sequence in ascending group-rank order) with
    ``fn`` in the doubling butterfly's association; see the module
    docstring."""
    acc = list(blocks)
    k, w = len(acc), 1
    while w < k:
        acc = [fn(acc[p], acc[p + w]) if p + w < k else acc[p] for p in range(k)]
        w *= 2
    return acc[0]


def mpx_error(exc_type, code: str, message: str):
    """Build an exception tagged with a stable MPX code: the code rides
    along as ``exc.mpx_code`` and is appended to the message."""
    if code not in CODES:
        raise KeyError(f"unknown MPX code {code}")
    exc = exc_type(f"{message} [{code}]")
    exc.mpx_code = code
    return exc


def check_send_recv(sendbuf, recvbuf, what: str) -> None:
    """MPI's type-signature rule: equal dtypes, and shapes that differ only
    where the element counts match (the result takes ``recvbuf``'s shape)."""
    if sendbuf.dtype != recvbuf.dtype:
        raise mpx_error(
            ValueError, "MPX106",
            f"{what} requires matching send/recv dtypes (MPI type-signature "
            f"rule); got {sendbuf.dtype} vs {recvbuf.dtype}",
        )
    if sendbuf.shape != recvbuf.shape and sendbuf.numel() != recvbuf.numel():
        raise mpx_error(
            ValueError, "MPX106",
            f"{what}: send/recv buffers may differ in shape only when their "
            f"element counts match (the output is typed by recvbuf); got "
            f"{tuple(sendbuf.shape)} vs {tuple(recvbuf.shape)}",
        )


def check_root(root: int, size: int, what: str) -> None:
    """A static root must name a rank of the communicator (MPX105); on a
    color split, ``size`` is the smallest group's."""
    if isinstance(root, bool) or not isinstance(root, int):
        raise TypeError(f"{what}: root must be an int, got {type(root).__name__}")
    if not 0 <= root < size:
        raise mpx_error(
            ValueError, "MPX105",
            f"{what} root {root} out of range for size {size}",
        )


def check_comm(comm, what: str):
    """The comm an op runs on: ``comm``, or inside a region
    (``parallel/region.py``) the region's when ``comm`` is ``None``.
    Inside a region it first issues the fusion queue (``ops/_fusion.py``):
    an op that reaches here does not join it, and program order holds."""
    ctx = current_context()
    if ctx is not None:
        flush_pending(ctx)
        if comm is None:
            comm = ctx.comm
    if comm is None:
        raise ValueError(f"{what}: pass comm= (no default communicator "
                         "outside a region: spmd, run)")
    return comm
