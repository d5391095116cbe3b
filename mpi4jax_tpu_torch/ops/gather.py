"""gather: collect every rank's tensor at root.

PyTorch counterpart of ``mpi4jax_tpu/ops/gather.py``, with the same
uniform result: every rank receives the gathered ``(size, *s)`` tensor
(root's view is what MPI's gather gives root).
"""

from __future__ import annotations

from typing import Optional

from ..parallel.comm import Comm
from ..parallel.mesh import MULTI_RANK_ITEM
from ._base import check_root
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
    if size != 1:
        raise NotImplementedError(
            f"gather over {size} ranks needs process groups; see "
            f"{MULTI_RANK_ITEM}"
        )
    return x.unsqueeze(0).clone(), produce(token)
