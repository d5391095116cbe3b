"""gather: collect every rank's tensor at root.

PyTorch counterpart of ``mpi4jax_tpu/ops/gather.py``, with the same
uniform result: every rank receives the gathered ``(size, *s)`` tensor in
comm-rank order (root's view is what MPI's gather gives root).  Over
several ranks it is one ``all_gather`` on the comm's process group, with
its buffers from ``ops/_staging.py`` as ``sendrecv``'s are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from ._base import check_root
from ._staging import Exchange
from .token import Token, produce


def gather(x, root: int, *, comm: Optional[Comm] = None,
           token: Optional[Token] = None):
    """Gather ``x`` from every rank to ``root``; every rank gets the
    ``(size, *x.shape)`` result.  Returns ``(result, token)``."""
    if comm is None:
        raise ValueError("gather: pass comm= (no default communicator yet)")
    if isinstance(root, bool) or not isinstance(root, int):
        raise TypeError(f"gather: root must be an int, got {type(root).__name__}")
    size = comm.Get_size()
    check_root(root, size, "gather")
    if size == 1:
        return x.unsqueeze(0).clone(), produce(token)
    with Exchange(x.device) as ex:
        parts = [ex.buffer(x) for _ in range(size)]
        dist.all_gather(parts, ex.send(x), group=comm.group())
        # all_gather orders by group rank, i.e. by ascending global rank
        by_global = dict(zip(sorted(comm.members()), parts))
        out = ex.result(torch.stack([by_global[g] for g in comm.members()]))
    return out, produce(token)
