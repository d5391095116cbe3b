"""bcast: broadcast from root.

PyTorch counterpart of ``mpi4jax_tpu/ops/bcast.py``: every rank receives
root's value with the input's shape; root gets its own input back.
``root`` is a rank of the comm (of every group, on a color split), checked
with MPX105.  Over several ranks the lowering is picked as the JAX
package picks it (``select_bcast``): under ``auto`` on a whole comm the
native route, else the selector's ``butterfly`` (the doubling broadcast),
``ring`` (van de Geijn: binomial-halving scatter and ring allgather,
``ops/_algos.py``) or ``hier`` (``ops/_hierarchy.py``).  The native route
and the butterfly are one ``dist.broadcast`` on the comm's process group,
with its buffer from ``ops/_staging.py``; every lowering is pure routing,
so all give root's bits.

Autodiff (``_Bcast``): the backward sums the cotangents of every rank onto
root (``_ReduceToRoot``) and gives the other ranks zeros, the transpose of
the JAX package's masked ``psum``; with each rank's loss ``sum(y**2)``
root's gradient is ``2 * size * x_root``.  ``_ReduceToRoot``'s backward is
the broadcast again.  The forward mode broadcasts root's tangent.  Under
fusion, a bcast inside a region is queued and packed with its same-root
neighbours (``ops/_fusion.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..analysis import hook as _analysis
from ..analysis.hook import dtype_name
from ..parallel.comm import Comm
from ..utils import config
from . import _fusion
from ._base import check_comm, check_root, lowered, meta_like, run_body
from ._staging import Exchange
from .token import Token, produce


def broadcast(x: torch.Tensor, root: int, comm: Comm) -> torch.Tensor:
    """Comm rank ``root``'s ``x`` on every rank; ``x`` is not written."""
    with Exchange(x.device) as ex:
        buf = ex.send(x)
        if buf.data_ptr() == x.data_ptr():  # broadcast writes in place
            buf = buf.clone()
        dist.broadcast(buf, src=comm.global_rank(root), group=comm.group())
        return ex.result(buf)


def reduce_to_root(x: torch.Tensor, root: int, comm: Comm) -> torch.Tensor:
    """The sum of every rank's ``x`` on comm rank ``root``, zeros elsewhere."""
    with Exchange(x.device) as ex:
        buf = ex.send(x)
        if buf.data_ptr() == x.data_ptr():  # reduce writes in place
            buf = buf.clone()
        dist.reduce(buf, dst=comm.global_rank(root), op=dist.ReduceOp.SUM,
                    group=comm.group())
        out = ex.result(buf)
    return out if comm.Get_rank() == root else torch.zeros_like(x)


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(x, root, comm):
        return broadcast(x, root, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.root, ctx.comm = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _ReduceToRoot.apply(g, ctx.root, ctx.comm), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return broadcast(t, ctx.root, ctx.comm)


class _ReduceToRoot(torch.autograd.Function):
    @staticmethod
    def forward(x, root, comm):
        return reduce_to_root(x, root, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.root, ctx.comm = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Bcast.apply(g, ctx.root, ctx.comm), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        return reduce_to_root(t, ctx.root, ctx.comm)


def bcast(x, root: int, *, comm: Optional[Comm] = None,
          token: Optional[Token] = None):
    """Broadcast ``x`` from rank ``root`` to all ranks.  Returns
    ``(result, token)``."""
    deferred = _fusion.maybe_defer("bcast", x, comm, token, root=root)
    if deferred is not None:
        return deferred
    comm = check_comm(comm, "bcast")
    check_root(root, comm.min_size(), "bcast")

    def body(comm, arrays, token):
        (x,) = arrays
        if len(comm.members()) == 1:
            return x.clone(), produce(token)
        return run_bcast(x, root, comm, *select_bcast(x, comm)), produce(token)

    def abstract(arrays, token):
        if len(comm.members()) > 1:
            select_bcast(arrays[0], comm)
        return meta_like(arrays[0]), produce(token)

    return run_body("bcast", comm, body, (_fusion.materialize_value(x),), token,
                    ana={"root": root}, abstract=abstract)


def select_bcast(x: torch.Tensor, comm: Comm):
    """The lowering of a broadcast of ``x``, as the JAX package's ``bcast``
    picks it: ``(algo, plan, k)``, annotated.  Runs in abstract runs
    too."""
    from . import _algos, _hierarchy

    algo = config.collective_algo()
    if comm.groups is None and algo == "auto":
        _analysis.annotate(algo="native")
        return "native", None, None
    k = _algos.static_group_size(comm)
    plan = _hierarchy.hier_plan(comm) if k is not None and k > 1 else None
    nbytes = x.numel() * x.element_size()
    picked = _algos.resolve_algo(algo, nbytes, k or 1,
                                 ring_ok=k is not None and k > 1,
                                 hier_ok=plan is not None)
    _hierarchy.annotate_selection("bcast", picked, nbytes, k or 1, plan, comm,
                                  dtype=dtype_name(x.dtype))
    return picked, plan, k


def run_bcast(x: torch.Tensor, root: int, comm: Comm, algo: str, plan,
              k) -> torch.Tensor:
    """Run the lowering ``select_bcast`` picked (native and butterfly: one
    ``dist.broadcast``)."""
    from . import _algos, _hierarchy

    if algo == "hier":
        run = lambda v: _hierarchy.apply_hier_bcast(v, comm, root, plan)
    elif algo == "ring":
        run = lambda v: _algos.apply_vdg_bcast(v, comm, root, k)
    else:
        return _Bcast.apply(x, root, comm)
    return lowered(x, run, lambda v: _Bcast.apply(v, root, comm))
