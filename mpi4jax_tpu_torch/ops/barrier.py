"""barrier: synchronization point.

PyTorch counterpart of ``mpi4jax_tpu/ops/barrier.py``: no rank returns
before every rank of the comm has called it, so what follows it on any
rank comes after what preceded it on every rank.  It is a one-element
SUM ``all_reduce`` on the comm's process group, waited for on the host
(through ``ops/_staging.py``, which first waits for the card's queued
work on gloo).  Returns a token.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from ._base import check_comm, run_body
from ._staging import Exchange
from .send import reap
from .token import Token, produce


def barrier(*, comm: Optional[Comm] = None, token: Optional[Token] = None):
    """Synchronize all ranks of ``comm``.  Returns a token."""
    comm = check_comm(comm, "barrier")

    def body(comm, arrays, token):
        if len(comm.members()) > 1:
            device = comm.device
            with Exchange(device) as ex:
                buf = ex.send(torch.zeros(1, device=device))
                dist.all_reduce(buf, group=comm.group())
                ex.result(buf).cpu()  # the host waits for the collective
        reap()
        return produce(token)

    return run_body("barrier", comm, body, (), token)
