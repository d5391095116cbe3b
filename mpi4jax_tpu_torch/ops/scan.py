"""scan: inclusive prefix reduction over rank order.

PyTorch counterpart of ``mpi4jax_tpu/ops/scan.py``: rank r receives
``x_0 op x_1 op ... op x_r`` in comm-rank (group-rank) order.  Built as
the JAX package builds it, Hillis-Steele: ``ceil(log2 size)`` rounds of
``sendrecv`` with ``shift(d, wrap=False)`` for d = 1, 2, 4, ..., in which
rank r combines ``fn(acc, received)`` when ``r >= d``.  The association
is the JAX package's, so an f32 SUM agrees bit for bit, and the gradient
(both modes) is ``sendrecv``'s.  On a color split each group runs its own
prefix, unequal groups included: the rounds go up to the largest group,
and a rank whose group has no pair in a round sends nothing.  A rank
below d that still sends keeps ``sendrecv``'s output (its own value) as
its accumulator, so the round stays on its autograd graph and its
backward receives the cotangent that comes back.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.comm import Comm
from ..parallel.rankspec import shift
from ._base import SUM, OpLike, check_comm, combine_fn, run_body
from .sendrecv import sendrecv
from .token import Token, produce


def scan(x, op: OpLike = SUM, *, comm: Optional[Comm] = None,
         token: Optional[Token] = None):
    """Inclusive prefix reduction: rank r gets ``x_0 op ... op x_r``.
    Returns ``(result, token)``."""
    comm = check_comm(comm, "scan")
    fn = combine_fn(op)
    rank = comm.Get_rank()
    sizes = [len(g) for g in comm.groups] if comm.groups else [comm.Get_size()]

    def body(comm, arrays, token):
        (x,) = arrays
        acc, d = x, 1
        while d < max(sizes):
            received, _ = sendrecv(acc, acc, dest=shift(d, wrap=False), comm=comm)
            combined = fn(acc, received)
            # jnp.where's promotion: a logical fold of ints stays int
            dtype = torch.promote_types(combined.dtype, received.dtype)
            acc = (combined if rank >= d else received).to(dtype)
            d *= 2
        return (acc.clone() if acc is x else acc), produce(token)

    return run_body("scan", comm, body, (x,), token)
