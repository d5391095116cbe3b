"""reduce: reduction to root.

PyTorch counterpart of ``mpi4jax_tpu/ops/reduce.py``: root receives the
reduction and every other rank its own input back.  ``root`` is a rank of
the comm (of every group, on a color split), checked with MPX105.  The
reduction is ``allreduce``'s, picked as the JAX package picks it
(``allreduce.py:select_allreduce``); where that is the native route, SUM
is one ``dist.reduce`` (``bcast.py:_ReduceToRoot``).  The result is selected per rank with ``torch.where``, as
the JAX package's ``jnp.where`` does, which keeps the reduction on every
rank's autograd graph: its backward is a collective that every rank must
run.  Rank s's gradient is its own cotangent where s is not root, plus
root's cotangent, which reaches every contributing rank (the transpose of
the JAX package's reduce).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.comm import Comm
from ._base import (SUM, OpLike, check_comm, check_root, combine_fn,
                    reduction_name, run_body)
from .allreduce import abstract_allreduce, run_allreduce, select_allreduce
from .bcast import _ReduceToRoot
from .token import Token, produce


def reduce(x, op: OpLike, root: int, *, comm: Optional[Comm] = None,
           token: Optional[Token] = None):
    """Reduce ``x`` with ``op`` to rank ``root``; the other ranks receive
    their input unchanged.  Returns ``(result, token)``."""
    comm = check_comm(comm, "reduce")
    check_root(root, comm.min_size(), "reduce")
    combine_fn(op)

    def body(comm, arrays, token):
        (x,) = arrays
        if len(comm.members()) == 1:
            return x.clone(), produce(token)
        algo, plan, k = select_allreduce(x, op, comm)
        if algo == "native" and op is SUM and x.dtype != torch.bool:
            reduced = _ReduceToRoot.apply(x, root, comm)
        else:
            reduced = run_allreduce(x, op, comm, algo, plan, k)
        is_root = torch.tensor(comm.Get_rank() == root, device=x.device)
        return torch.where(is_root, reduced, x), produce(token)

    return run_body("reduce", comm, body, (x,), token,
                    ana={"root": root, "reduction": reduction_name(op)},
                    abstract=lambda a, t: (abstract_allreduce(a[0], op, comm),
                                           produce(t)))
