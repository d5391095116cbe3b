"""alltoall: transpose data across ranks.

PyTorch counterpart of ``mpi4jax_tpu/ops/alltoall.py`` (its flat
algorithm), with the same contract: the input is ``(size, *s)`` and the
output ``(size, *s)``, where ``out[i]`` is the slice that rank ``i``
addressed to this rank; a leading axis other than the comm size raises
``ValueError`` with the JAX package's wording.  On a size-1 comm it is a
copy.  Over several ranks it is one ``dist.all_to_all_single`` on the
comm's process group, with its buffers from ``ops/_staging.py`` as
``gather``'s are.  The group orders its ranks by global rank; the rows
are permuted to and from comm-rank order around the exchange where the
two differ.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.comm import Comm
from ._staging import Exchange
from .token import Token, produce


def alltoall(x, *, comm: Optional[Comm] = None, token: Optional[Token] = None):
    """Exchange slices: rank ``r`` sends ``x[i]`` to rank ``i`` and receives
    into ``out[i]`` from rank ``i``.  Returns ``(result, token)``."""
    if comm is None:
        raise ValueError("alltoall: pass comm= (no default communicator yet)")
    size = comm.Get_size()
    if x.ndim == 0 or x.shape[0] != size:
        raise ValueError(
            f"alltoall input must have leading axis == comm size "
            f"({size}), got shape {tuple(x.shape)} (ref alltoall.py:71-73)"
        )
    if size == 1:
        return x.clone(), produce(token)
    members = comm.members()
    # by_group[j]: the comm rank of group rank j (ascending global rank)
    by_group = sorted(range(size), key=members.__getitem__)
    permuted = by_group != list(range(size))
    if permuted:
        x = x[by_group]
    with Exchange(x.device) as ex:
        recv = ex.buffer(x)
        dist.all_to_all_single(recv, ex.send(x), group=comm.group())
        out = ex.result(recv)
    if permuted:
        unsorted = torch.empty_like(out)
        unsorted[by_group] = out
        out = unsorted
    return out, produce(token)
