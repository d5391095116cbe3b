"""gather: collect every rank's tensor at root.

PyTorch counterpart of ``mpi4jax_tpu/ops/gather.py``, with the same
uniform result: every rank receives the gathered ``(size, *s)`` tensor in
comm-rank order (root's view is what MPI's gather gives root).  It is
``allgather``'s exchange (``allgather.py``), and differentiates as it
does.
"""

from __future__ import annotations

from typing import Optional

from ..parallel.comm import Comm
from ._base import check_comm, check_root, run_body
from .allgather import allgather_any
from .token import Token, produce


def gather(x, root: int, *, comm: Optional[Comm] = None,
           token: Optional[Token] = None):
    """Gather ``x`` from every rank to ``root``; every rank gets the
    ``(size, *x.shape)`` result.  Returns ``(result, token)``."""
    comm = check_comm(comm, "gather")
    check_root(root, comm.Get_size(), "gather")
    return run_body("gather", comm,
                    lambda c, a, t: (allgather_any(a[0], c), produce(t)),
                    (x,), token)
