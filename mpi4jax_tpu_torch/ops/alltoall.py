"""alltoall: transpose data across ranks.

PyTorch counterpart of ``mpi4jax_tpu/ops/alltoall.py`` (its flat
algorithm), with the same contract: the input is ``(size, *s)`` and the
output ``(size, *s)``, where ``out[i]`` is the slice that rank ``i``
addressed to this rank; a leading axis other than the comm size raises
``ValueError`` with the JAX package's wording.  On a size-1 comm it is a
copy.  Over several ranks the lowering is picked as the JAX package picks
it (``_algos.resolve_alltoall_algo``): the two-level ``hier`` alltoall
(``ops/_hierarchy.py``) on a comm of several hosts at and above
``MPI4JAX_TPU_ALLTOALL_CROSSOVER_BYTES`` (or forced), else the flat one,
one ``dist.all_to_all_single`` on the comm's process group, with its
buffers from ``ops/_staging.py`` as ``gather``'s are.  Both are pure
routing: the same bits.  The group orders its ranks by global rank; the rows
are permuted to and from comm-rank order around the exchange where the
two differ.

The exchange runs inside a ``torch.autograd.Function`` whose backward is
the same ``alltoall`` of the cotangent: the op is its own transpose, as
``lax.all_to_all`` is to the JAX package; its forward mode is the
``alltoall`` of the tangent.  The tensors handed to ``torch.distributed``
are detached and contiguous.  On a color split the comm is this rank's
group, whose size only uniform splits have (``GroupComm.Get_size``).
Inside ``overlap()`` the call is split into ``alltoall_start`` and a
deferred wait (``ops/_async.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..analysis.hook import dtype_name
from ..parallel.comm import Comm
from . import _async
from ._base import (BLOCKS, Exchanged, check_comm, exchange, lowered, meta_like,
                    run_body)
from ._fusion import materialize_value
from ._staging import Exchange
from .token import Token, produce


def group_order(comm: Comm):
    """``by_group[j]``, the comm rank of group rank j (ascending global
    rank), where the two orders differ; else ``None``."""
    members = comm.members()
    by_group = sorted(range(len(members)), key=members.__getitem__)
    return by_group if by_group != list(range(len(members))) else None


def unpermute(out: torch.Tensor, by_group) -> torch.Tensor:
    """Rows received in group-rank order back in comm-rank order."""
    if by_group is None:
        return out
    unsorted = torch.empty_like(out)
    unsorted[by_group] = out
    return unsorted


def _exchange(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """One multi-rank alltoall of ``x`` (leading axis = the group size)."""
    return exchange(lambda v: _all_to_all(v, comm), BLOCKS, x.detach())


def _all_to_all(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    by_group = group_order(comm)
    x = x.detach()
    if by_group is not None:
        x = x[by_group]
    with Exchange(x.device) as ex:
        recv = ex.buffer(x)
        dist.all_to_all_single(recv, ex.send(x), group=comm.group())
        out = ex.result(recv)
    return unpermute(out, by_group)


class _AllToAll(Exchanged):
    """The exchange, whose backward is the alltoall of the cotangent (rank
    r's slice i went to rank i's slot r, and back)."""

    layout = BLOCKS

    @staticmethod
    def forward(x, comm):
        return _exchange(x, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.comm), None

    @staticmethod
    def jvp(ctx, t, _):
        return _exchange(t, ctx.comm)


def alltoall(x, *, comm: Optional[Comm] = None, token: Optional[Token] = None):
    """Exchange slices: rank ``r`` sends ``x[i]`` to rank ``i`` and receives
    into ``out[i]`` from rank ``i``.  Returns ``(result, token)``."""
    lazy = _async.maybe_lazy("alltoall", x, None, comm, token)
    if lazy is not None:
        return lazy
    comm = check_comm(comm, "alltoall")
    x = materialize_value(x)
    size = comm.Get_size()
    if x.ndim == 0 or x.shape[0] != size:
        raise ValueError(
            f"alltoall input must have leading axis == comm size "
            f"({size}), got shape {tuple(x.shape)} (ref alltoall.py:71-73)"
        )

    def body(comm, arrays, token):
        (x,) = arrays
        if size == 1:
            return x.clone(), produce(token)
        algo, plan = select_alltoall(x, comm)
        if algo == "hier":
            from ._hierarchy import apply_hier_alltoall

            return lowered(x, lambda v: apply_hier_alltoall(v, comm, plan),
                           lambda v: _AllToAll.apply(v, comm)), produce(token)
        return _AllToAll.apply(x, comm), produce(token)

    def abstract(arrays, token):
        if size > 1:
            select_alltoall(arrays[0], comm)
        return meta_like(arrays[0]), produce(token)

    return run_body("alltoall", comm, body, (x,), token, abstract=abstract)


def select_alltoall(x: torch.Tensor, comm: Comm, flat: str = "native"):
    """The lowering of an alltoall of ``x``, as the JAX package picks it:
    ``(algo, plan)``, ``algo`` ``"hier"`` or ``flat``, annotated.  Runs in
    abstract runs too."""
    from ..utils import config
    from . import _algos, _hierarchy

    size = comm.Get_size()
    nbytes = x.numel() * x.element_size()
    plan = _hierarchy.hier_plan(comm) if size > 1 else None
    algo = _algos.resolve_alltoall_algo(config.collective_algo(), nbytes,
                                        hier_ok=plan is not None, flat=flat)
    _hierarchy.annotate_selection("alltoall", algo, nbytes, size, plan, comm,
                                  dtype=dtype_name(x.dtype))
    return algo, plan
